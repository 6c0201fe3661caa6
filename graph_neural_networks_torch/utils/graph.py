"""Host-side graph math (numpy/scipy) that the ported models need.

The port's own copy of the pieces of the JAX package's
``utils/graph.py`` that the ported slices use: node orderings (Identity,
Degree, SpectralProxies, EDS, RCM), K-hop neighborhood tables for
selection pooling and the local activations, the structure tables of the
static filter families (node-variant tap copies, edge-variant sparsity
masks, the spectral filters' B-spline basis), Graclus multilevel
coarsening, and for the source-localization task the graph generators
(SBM, SmallWorld, fuseEdges), the ``Graph`` container, the GFT, matrix
powers and source-node selection. Like there, everything here runs once at
build time on the host (the neighborhoods and the Graclus matching in the
native library, ``utils/native.py``, unless ``GNT_NO_NATIVE`` is set), and
a generator draws from the numpy `rng` in the JAX package's order, so one
seed gives the same graphs in both packages.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse
import scipy.sparse.csgraph
import scipy.spatial.distance as _spdist

from graph_neural_networks_torch.utils import native

ZERO_TOL = 1e-9

__all__ = ["adjacency_to_laplacian", "normalize_adjacency",
           "normalize_laplacian", "compute_gft", "matrix_powers",
           "compute_neighborhood", "compute_source_nodes",
           "spectral_clustering", "is_connected",
           "create_graph", "Graph", "perm_identity", "perm_degree",
           "perm_spectral_proxies", "perm_eds", "perm_rcm",
           "permutation_by_name", "compute_nonzero_rows", "nv_copy_nodes",
           "ev_sparsity_pattern", "spline_basis", "compute_coarsening_perm",
           "coarsen", "pad_coarsened_data", "sparsify_graph",
           "edge_fail_sampling", "plot_graph", "print_graph"]


# ---------------------------------------------------------------------------
# Rendering (reference graphTools.py:52-201); matplotlib is imported here
# only, so that nothing on an import path needs it
# ---------------------------------------------------------------------------

def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    # no LaTeX in a headless environment (the reference turns usetex on)
    matplotlib.rcParams["text.usetex"] = False
    import matplotlib.pyplot as plt
    return plt


def plot_graph(A, pos=None, fig_size=5, node_size=100, save_to=None):
    """Render a graph with matplotlib: positions from the 2nd and 3rd
    Laplacian eigenvectors unless `pos` is given. Returns the figure (and
    saves a PNG when save_to is set)."""
    plt = _pyplot()
    A = np.asarray(A)
    if pos is None:
        L = adjacency_to_laplacian((np.abs(A) + np.abs(A.T)) / 2)
        _, V = np.linalg.eigh(L)
        pos = V[:, 1:3]
    fig, ax = plt.subplots(figsize=(fig_size, fig_size))
    ii, jj = np.nonzero(np.triu(np.abs(A) + np.abs(A.T)))
    for i, j in zip(ii, jj):
        ax.plot([pos[i, 0], pos[j, 0]], [pos[i, 1], pos[j, 1]],
                color="0.7", lw=0.5, zorder=1)
    ax.scatter(pos[:, 0], pos[:, 1], s=node_size, zorder=2)
    ax.set_axis_off()
    if save_to:
        fig.savefig(save_to, bbox_inches="tight")
    return fig


def print_graph(A, save_to=None):
    """Render the adjacency matrix as an image (spy plot)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(4, 4))
    ax.imshow(np.abs(np.asarray(A)) > ZERO_TOL, cmap="Greys",
              interpolation="nearest")
    ax.set_xlabel("node"), ax.set_ylabel("node")
    if save_to:
        fig.savefig(save_to, bbox_inches="tight")
    return fig


def adjacency_to_laplacian(W: np.ndarray) -> np.ndarray:
    """Combinatorial Laplacian L = D - W."""
    if W.shape[0] != W.shape[1]:
        raise ValueError(f"W must be square, got {W.shape}")
    return np.diag(W.sum(axis=1)) - W


def normalize_adjacency(W: np.ndarray) -> np.ndarray:
    """Symmetric degree normalization D^{-1/2} W D^{-1/2}."""
    if W.shape[0] != W.shape[1]:
        raise ValueError(f"W must be square, got {W.shape}")
    d_isqrt = 1.0 / np.sqrt(W.sum(axis=1))
    return W * d_isqrt[:, None] * d_isqrt[None, :]


def normalize_laplacian(L: np.ndarray) -> np.ndarray:
    """Symmetric normalized Laplacian D^{-1/2} L D^{-1/2} (diag(L) = degrees)."""
    if L.shape[0] != L.shape[1]:
        raise ValueError(f"L must be square, got {L.shape}")
    d_isqrt = 1.0 / np.sqrt(np.diag(L))
    return L * d_isqrt[:, None] * d_isqrt[None, :]


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

    A breadth-first search a row in the native library
    (``utils.native.bfs_khop``, as the JAX package), unless
    ``GNT_NO_NATIVE`` is set; its numpy plain version takes reachability
    as R_K = bool((I + A)^K), K sparse boolean products.
    """
    if output_type not in ("list", "matrix"):
        raise ValueError(f"unknown output_type {output_type!r}")
    A = _binary_connectivity(S)
    N = A.shape[0]
    n_rows = N if n_rows is None else int(n_rows)
    nb = N if nb is None else int(nb)
    if not (0 <= n_rows <= N and 0 <= nb <= N):
        raise ValueError(f"n_rows={n_rows}, nb={nb} out of range for N={N}")

    if native.enabled():
        tbl, counts = native.bfs_khop(A.indptr, A.indices, N, K, n_rows, nb)
        if output_type == "matrix":
            return tbl
        return [tbl[i, :counts[i]].copy() for i in range(n_rows)]
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


def _discretize(vectors, rs, max_svd_restarts=30, n_iter_max=20):
    """The partition matrix closest to a spectral embedding (Yu and Shi,
    "Multiclass spectral clustering", 2003): scikit-learn's
    ``cluster.discretize``, the same draws from the RandomState `rs`."""
    eps = np.finfo(float).eps
    n_samples, n_components = vectors.shape
    vectors = vectors.copy()
    norm_ones = np.sqrt(n_samples)
    for i in range(n_components):
        vectors[:, i] = vectors[:, i] / np.linalg.norm(vectors[:, i]) * \
            norm_ones
        if vectors[0, i] != 0:
            vectors[:, i] = -1 * vectors[:, i] * np.sign(vectors[0, i])
    vectors = vectors / np.sqrt((vectors ** 2).sum(axis=1))[:, None]
    for _ in range(max_svd_restarts):
        rotation = np.zeros((n_components, n_components))
        rotation[:, 0] = vectors[rs.randint(n_samples), :].T
        c = np.zeros(n_samples)
        for j in range(1, n_components):
            c += np.abs(np.dot(vectors, rotation[:, j - 1]))
            rotation[:, j] = vectors[c.argmin(), :].T
        last_objective_value = 0.0
        n_iter = 0
        while True:
            n_iter += 1
            labels = np.dot(vectors, rotation).argmax(axis=1)
            discrete = scipy.sparse.csc_array(
                (np.ones(len(labels)), (np.arange(n_samples), labels)),
                shape=(n_samples, n_components))
            try:
                U, S, Vh = np.linalg.svd(discrete.T @ vectors)
            except np.linalg.LinAlgError:
                break                         # a new random rotation
            ncut_value = 2.0 * (n_samples - S.sum())
            if (abs(ncut_value - last_objective_value) < eps
                    or n_iter > n_iter_max):
                return labels
            last_objective_value = ncut_value
            rotation = np.dot(Vh.T, U.T)
    raise np.linalg.LinAlgError("SVD did not converge")


def spectral_clustering(A: np.ndarray, C: int, seed=0) -> np.ndarray:
    """Labels of C communities of the affinity A: scikit-learn's
    ``SpectralClustering(n_clusters=C, affinity="precomputed",
    assign_labels="discretize", random_state=seed)`` (as of scikit-learn
    1.9; the JAX package calls it) in numpy and scipy, drawing from the same
    RandomState: the normalized Laplacian's C smallest eigenvectors by
    shift-invert ARPACK (``eigsh``, sigma -1e-5, from a uniform start
    vector), scaled by D^-1/2 and sign-fixed, then ``_discretize``."""
    from scipy.sparse.csgraph import laplacian as csgraph_laplacian
    from scipy.sparse.linalg import eigsh
    rs = np.random.RandomState(seed)
    A = np.asarray(A, dtype=np.float64)
    if not np.allclose(A, A.T, atol=1e-10):
        A = 0.5 * (A + A.T)
    N = A.shape[0]
    L, dd = csgraph_laplacian(A, normed=True, return_diag=True)
    L.flat[::N + 1] = 1.0
    v0 = rs.uniform(-1, 1, N)
    _, V = eigsh(L, k=C, sigma=-1e-5, which="LM", tol=0, v0=v0)
    emb = V.T[:C] / dd
    rows = np.argmax(np.abs(emb), axis=1)
    emb *= np.sign(emb[np.arange(C), rows])[:, None]
    return _discretize(emb.T, rs)


def compute_source_nodes(A: np.ndarray, C: int, seed=0):
    """Spectral-cluster A into C communities (:func:`spectral_clustering`,
    the JAX package's scikit-learn clustering without scikit-learn);
    return the max-degree node of each community (the class labels of the
    source-localization task)."""
    degree = A.sum(axis=0)
    labels = spectral_clustering(A, C, seed)
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


def sparsify_graph(W: np.ndarray, kind: str, p):
    """Sparsify by 'threshold' (drop |w| < p, halving p until connected) or
    'NN' (keep p largest incoming edges per row, incrementing p until
    connected; re-symmetrized by averaging if the input was undirected)."""
    N = W.shape[0]
    if W.shape[1] != N or kind not in ("threshold", "NN"):
        raise ValueError(f"sparsify_graph: {W.shape}, {kind!r}")
    connected = is_connected(W)
    undirected = np.allclose(W, W.T, atol=ZERO_TOL)
    if kind == "threshold":
        def apply(thr):
            Wn = W.copy()
            Wn[np.abs(Wn) < thr] = 0.0
            return Wn
        Wnew = apply(p)
        while connected and not is_connected(Wnew):
            p = p / 2.0
            Wnew = apply(p)
    else:
        Wsorted = np.sort(W, axis=1)

        def apply(k):
            kth = Wsorted[:, -k].reshape(N, 1)
            return W * (W >= kth).astype(W.dtype)
        Wnew = apply(p)
        while connected and not is_connected(Wnew):
            p += 1
            Wnew = apply(p)
        if undirected:
            Wnew = 0.5 * (Wnew + Wnew.T)
    return Wnew


def edge_fail_sampling(W, p, rng=None):
    """Delete each edge iid with probability p (robustness experiments;
    an undirected graph stays undirected: its upper triangle is drawn)."""
    if not 0 <= p <= 1:
        raise ValueError(f"p must lie in [0, 1], got {p}")
    rng = np.random.default_rng() if rng is None else rng
    undirected = np.allclose(W, W.T, atol=ZERO_TOL)
    mask = (rng.random(W.shape) > p).astype(W.dtype)
    W = mask * W
    if undirected:
        W = np.triu(W)
        W = W + W.T
    return W


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


def _create_small_world(N, prob_edge, prob_rewiring, rng):
    """Distance-ranked local connections on a circle, then Watts-Strogatz
    rewiring, resampled until connected (reference graphTools.py:801-858)."""
    angles = 2 * np.pi * np.arange(N) / N
    pos = np.stack([np.cos(angles), np.sin(angles)], axis=1)
    D = _spdist.squareform(_spdist.pdist(pos)) ** 2
    while True:
        W = np.zeros((N, N))
        # locally connected network with a binomial in-degree
        for n in range(N):
            k = rng.binomial(N, prob_edge)
            others = np.concatenate([np.arange(n), np.arange(n + 1, N)])
            ranked = others[np.argsort(D[n, others])]
            dists = D[n, ranked]
            ties = np.flatnonzero(dists == dists[min(k, N - 2)])
            if len(ties) <= 1:
                W[ranked[:k], n] = 1
            else:
                first_tie = ties.min()
                W[ranked[:first_tie], n] = 1
                shuffled = rng.permutation(len(ties))
                take = max(k - first_tie + 1, 0)
                W[ranked[first_tie + shuffled[:take]], n] = 1
        # rewiring
        for n in range(N):
            for j in np.flatnonzero(W[:, n]):
                if rng.random() < prob_rewiring:
                    free = 1 - W[:, n]
                    free[n] = 0
                    free[j] = 1
                    candidates = np.flatnonzero(free)
                    W[j, n] = 0
                    W[candidates[rng.integers(len(candidates))], n] = 1
        W = np.triu(W)
        W = W + W.T
        if is_connected(W):
            return W


def _fuse_edges(opts):
    """Fuse a stack of adjacencies (nGraphs x N x N) into one graph.

    Options: adjacencyMatrices, aggregationType ('sum'|'avg'),
    normalizationType ('rows'|'cols'|'no'), isolatedNodes (keep them?),
    forceUndirected, forceConnected (keep the largest component),
    nodeList (out-parameter: extended with the surviving original node
    ids), extraComponents (optional out-parameter: the other components'
    adjacencies and node ids appended).
    """
    W = np.asarray(opts["adjacencyMatrices"])
    if not (W.ndim == 3 and W.shape[1] == W.shape[2]):
        raise ValueError(f"adjacencyMatrices must be (G, N, N), got "
                         f"{W.shape}")
    N = W.shape[1]
    node_list = opts["nodeList"]
    extra = opts.get("extraComponents", None)
    all_nodes = np.arange(N)

    W = W.sum(axis=0) if opts["aggregationType"] == "sum" else W.mean(axis=0)

    norm = opts["normalizationType"]
    if norm in ("rows", "cols"):
        s = W.sum(axis=1 if norm == "rows" else 0, keepdims=True)
        s[np.abs(s) < ZERO_TOL] = 1.0
        W = W / s

    if not opts["isolatedNodes"]:
        keep = np.flatnonzero(np.abs(W).sum(axis=0) > ZERO_TOL)
        if len(keep) < W.shape[0]:
            W = W[np.ix_(keep, keep)]
            all_nodes = all_nodes[keep]

    if opts["forceUndirected"]:
        W = 0.5 * (W + W.T)

    if opts["forceConnected"] and not is_connected(W):
        n_comp, labels = scipy.sparse.csgraph.connected_components(
            scipy.sparse.csr_matrix(np.abs(W) > ZERO_TOL), directed=False)
        comp_adj, comp_nodes = [], []
        for c in range(n_comp):
            members = np.flatnonzero(labels == c)
            comp_adj.append(W[np.ix_(members, members)])
            comp_nodes.append(all_nodes[members])
        largest = int(np.argmax([len(m) for m in comp_nodes]))
        W = comp_adj.pop(largest)
        all_nodes = comp_nodes.pop(largest)
        if extra is not None:
            extra.append(comp_adj)
            extra.append(comp_nodes)

    node_list.extend(all_nodes.tolist())
    return W


def create_graph(graph_type: str, N: int, options: dict, rng=None):
    """Graph generator: 'SBM', 'SmallWorld', 'fuseEdges' or 'adjacency'.
    Returns the (weighted) adjacency matrix."""
    rng = np.random.default_rng() if rng is None else rng
    if graph_type == "SBM":
        return _create_sbm(N, options["nCommunities"], options["probIntra"],
                           options["probInter"], rng)
    if graph_type == "SmallWorld":
        return _create_small_world(N, options["probEdge"],
                                   options["probRewiring"], rng)
    if graph_type == "fuseEdges":
        return _fuse_edges(options)
    if graph_type == "adjacency":
        W = np.asarray(options["adjacencyMatrix"])
        if W.shape != (N, N):
            raise ValueError(f"adjacency {W.shape} is not {N} x {N}")
        return W
    raise ValueError(f"unknown graph type: {graph_type!r}")


class Graph:
    """Build-time graph container.

    Attributes: N, M (edges), W (weighted adjacency), A (binary), D (degree
    matrix), L (Laplacian if undirected & no self-loops), S (GSO; defaults to
    W), E/V (the GFT of S: None until compute_gft or set_gso computes it),
    undirected, self_loops.
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
        self.E = None
        self.V = None

    def compute_gft(self):
        """E, V = the GFT of S in total-variation order."""
        if self.S is not None:
            self.E, self.V = compute_gft(self.S, order="totalVariation")

    def set_gso(self, S, gft: str = "no"):
        """Replace the GSO; gft other than 'no' also computes its GFT in
        that order ('increasing' or 'totalVariation'), 'no' clears it."""
        if not S.shape[0] == S.shape[1] == self.N:
            raise ValueError(f"S {S.shape} is not {self.N} x {self.N}")
        if gft not in ("no", "increasing", "totalVariation"):
            raise ValueError(f"unknown GFT order {gft!r}")
        self.S = S
        if gft == "no":
            self.E, self.V = None, None
        else:
            self.E, self.V = compute_gft(self.S, order=gft)


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


def perm_spectral_proxies(S, k: int = 8):
    """Greedy spectral-proxies ordering: repeatedly pick the node of
    largest magnitude in the minimum eigenvector of (S^T)^k S^k restricted
    to the nodes not chosen yet (reference graphTools.py:1054). N
    eigendecompositions on the host: for small graphs."""
    Sb, squeeze = _as_batched(S)
    M = Sb.mean(axis=0)
    N = M.shape[0]
    Mk = np.linalg.matrix_power(M, k)
    MTk_Mk = np.linalg.matrix_power(M.conj().T, k) @ Mk
    chosen: list = []
    remaining = list(range(N))
    while remaining:
        evals, evecs = np.linalg.eig(MTk_Mk[np.ix_(remaining, remaining)])
        phi = evecs[:, np.argmin(evals.real)]
        pick = int(np.argmax(np.abs(phi) ** 2))
        chosen.append(remaining.pop(pick))
    return _apply_order(Sb, np.asarray(chosen), squeeze), chosen


def perm_eds(S):
    """Experimentally-designed-sampling ordering: by decreasing
    kappa_i^2 = max_j |V_ij|^2 over the eigenbasis V of S."""
    Sb, squeeze = _as_batched(S)
    _, V = np.linalg.eig(Sb.mean(axis=0))
    kappa2 = np.max(np.abs(V), axis=1) ** 2
    order = np.flip(np.argsort(kappa2))
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
    "SpectralProxies": perm_spectral_proxies,
    "EDS": perm_eds,
    "RCM": perm_rcm,
}


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


# ---------------------------------------------------------------------------
# Multilevel (Graclus) coarsening -> binary-tree node order with fake nodes
# ---------------------------------------------------------------------------
# The Graclus/METIS multilevel coarsening (the public mdeff/cnn_graph
# algorithm the reference adapts, graphTools.py:1337-1614): greedily match
# nodes by normalized edge weight, halve the graph `levels` times, and
# derive a node order in which each coarse node's children are adjacent,
# so that pooling is a stride-2 max over the ordered axis, padded with fake
# (zero-signal) nodes wherever a match was a singleton.

def _match_one_level(W: scipy.sparse.csr_matrix, node_visit_order, weights):
    """One level of greedy Graclus matching. Returns the cluster ids."""
    N = W.shape[0]
    W = W.tocsr()
    marked = np.zeros(N, dtype=bool)
    cluster_id = np.zeros(N, dtype=np.int64)
    n_clusters = 0
    for tid in node_visit_order:
        if marked[tid]:
            continue
        marked[tid] = True
        best_gain, best_nbr = 0.0, -1
        lo, hi = W.indptr[tid], W.indptr[tid + 1]
        for j, v in zip(W.indices[lo:hi], W.data[lo:hi]):
            if marked[j]:
                continue
            gain = v * (1.0 / weights[tid] + 1.0 / weights[j])
            if gain > best_gain:
                best_gain, best_nbr = gain, j
        cluster_id[tid] = n_clusters
        if best_nbr >= 0:
            cluster_id[best_nbr] = n_clusters
            marked[best_nbr] = True
        n_clusters += 1
    return cluster_id


def _multilevel_matching(W, levels: int, rng):
    """`levels` Graclus halvings: the graphs (finest first) and each
    level's cluster ids. One ``rng.permutation`` draw, the first visit
    order; later levels visit by increasing degree. Each level's matching
    runs in the native library (``utils.native.graclus_match``) unless
    ``GNT_NO_NATIVE`` is set (:func:`_match_one_level`)."""
    use_native = native.enabled()
    W = scipy.sparse.csr_matrix(W)
    graphs = [W]
    parents = []
    visit = rng.permutation(W.shape[0])
    degree = np.asarray(W.sum(axis=0)).ravel() - W.diagonal()
    for _ in range(levels):
        if use_native:
            cluster_id, _ = native.graclus_match(
                W.indptr, W.indices, W.data, degree, visit, W.shape[0])
        else:
            cluster_id = _match_one_level(W, visit, degree)
        parents.append(cluster_id)
        row, col = W.nonzero()
        vals = np.asarray(W[row, col]).ravel()
        n_new = cluster_id.max() + 1
        W = scipy.sparse.csr_matrix(
            (vals, (cluster_id[row], cluster_id[col])), shape=(n_new, n_new))
        W.eliminate_zeros()
        graphs.append(W)
        degree = np.asarray(W.sum(axis=0)).ravel()
        visit = np.argsort(degree)
    return graphs, parents


def compute_coarsening_perm(parents):
    """Orders per level in which siblings sit at consecutive indices (a
    binary tree); singleton matches get fake-node indices appended after
    the real ones."""
    if not parents:
        return []
    orders = [list(range(parents[-1].max() + 1))]
    for parent in parents[::-1]:
        next_fake = len(parent)
        layer = []
        for coarse_idx in orders[-1]:
            children = list(np.flatnonzero(parent == coarse_idx))
            if len(children) > 2:
                raise ValueError("a Graclus match has more than two nodes")
            while len(children) < 2:
                children.append(next_fake)
                next_fake += 1
            layer.extend(children)
        orders.append(layer)
    orders = orders[::-1]
    for lvl, layer in enumerate(orders):
        if sorted(layer) != list(range(len(orders[0]) // (2 ** lvl))):
            raise ValueError(f"coarsening level {lvl} is not a binary tree")
    return orders


def _permute_adjacency(A: scipy.sparse.spmatrix, order):
    """Grow A with isolated fake nodes and reorder it so that `order` is
    contiguous."""
    if order is None:
        return A
    M_new = len(order)
    A = A.tocoo()
    inv = np.argsort(order)
    return scipy.sparse.coo_matrix((A.data, (inv[A.row], inv[A.col])),
                                   shape=(M_new, M_new))


def coarsen(A, levels: int, self_connections: bool = False, rng=None):
    """Multilevel-coarsen the adjacency A.

    Returns (graphs, order): `graphs` holds levels+1 CSR adjacencies whose
    node sets are padded and ordered as a binary tree (so pooling a layer
    is a max over pairs), and `order` is the level-0 node order (original
    node i sits at position order.index(i); None when levels is 0). The
    data are padded with zeros at the fake nodes (:func:`pad_coarsened_data`).
    """
    rng = np.random.default_rng() if rng is None else rng
    graphs, parents = _multilevel_matching(A, levels, rng)
    orders = compute_coarsening_perm(parents)
    out = []
    for lvl, G in enumerate(graphs):
        G = G.tocoo()
        if not self_connections:
            G.setdiag(0)
        if lvl < levels and orders:
            G = _permute_adjacency(G, orders[lvl])
        G = G.tocsr()
        G.eliminate_zeros()
        out.append(G)
    return out, (orders[0] if levels > 0 else None)


def pad_coarsened_data(x: np.ndarray, order) -> np.ndarray:
    """Reorder data (B x F x N) by the coarsening `order`, inserting
    zero-signal fake nodes (a zero loses every max-pool, so a singleton
    keeps its value)."""
    if order is None:
        return x
    B, F, N = x.shape
    out = np.zeros((B, F, len(order)), dtype=x.dtype)
    order = np.asarray(order)
    real = order < N
    out[:, :, np.flatnonzero(real)] = x[:, :, order[real]]
    return out
