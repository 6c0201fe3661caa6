"""Task datasets: the port's copy of the JAX package's ``data/datasets.py``
(reference ``alegnn/utils/dataTools.py``, cites below): source
localization, authorship attribution, MovieLens-100k, epidemics (SIR),
FacebookEgo, 20NEWS, and the word-graph helpers.

External files load from an explicit `data_dir`; when it is absent, each
dataset has the JAX package's documented synthetic fallback. Every
generator draws from the numpy `rng` in the JAX package's order, so one
seed gives the same arrays in both packages. Samples stay numpy on the
host; the trainers move each batch to the device. ``scipy.io`` reads the
authorship ``.mat`` files, ``h5py`` (imported only for a MATLAB v7.3
file) the HDF5 ones, ``sklearn`` only ``distance_sklearn_metrics``.
"""

from __future__ import annotations

import csv
import os
import pickle

import numpy as np

from graph_neural_networks_torch.data.base import (Data,
                                                   DataForClassification,
                                                   ZERO_TOL)
from graph_neural_networks_torch.utils import graph as gt


# ---------------------------------------------------------------------------
# Source localization (reference dataTools.py:473-592)
# ---------------------------------------------------------------------------

class SourceLocalization(DataForClassification):
    """x = (W/lmax)^t delta_source for t ~ U[0, tMax), source ~ U(sourceNodes);
    label = source index."""

    def __init__(self, G, nTrain, nValid, nTest, sourceNodes, tMax=None,
                 dataType=np.float64, rng=None, normalize=False):
        """normalize=True standardizes each node's signal with training-set
        statistics (not in the reference): for large tMax the inter-class
        differences shrink to ~1e-6 against O(0.1) magnitudes, and
        standardization rescales that fine structure."""
        super().__init__()
        rng = np.random.default_rng() if rng is None else rng
        self.dataType = dataType
        self.nTrain, self.nValid, self.nTest = nTrain, nValid, nTest
        if tMax is None:
            tMax = G.N
        E, _ = gt.compute_gft(G.W, order="totalVariation")
        Wnorm = G.W / np.max(np.diag(E).real)
        n_total = nTrain + nValid + nTest
        sources = rng.choice(sourceNodes, size=n_total)
        times = rng.choice(tMax, size=n_total)
        Wt = gt.matrix_powers(Wnorm, tMax)            # tMax x N x N
        x = Wt[times, :, sources]                     # columns of W^t
        node_to_label = {int(s): i for i, s in enumerate(sourceNodes)}
        labels = np.array([node_to_label[int(s)] for s in sources])
        sl = np.split(np.arange(n_total), [nTrain, nTrain + nValid])
        for name, idx in zip(("train", "valid", "test"), sl):
            self.samples[name]["signals"] = x[idx]
            self.samples[name]["targets"] = labels[idx]
        if normalize:
            xtr = self.samples["train"]["signals"]
            mu = xtr.mean(0, keepdims=True)
            sd = xtr.std(0, keepdims=True)
            sd[sd < ZERO_TOL] = 1.0
            for name in ("train", "valid", "test"):
                self.samples[name]["signals"] = \
                    (self.samples[name]["signals"] - mu) / sd
        self.astype(dataType)


# ---------------------------------------------------------------------------
# Authorship attribution (reference dataTools.py:594-1013)
# ---------------------------------------------------------------------------

class Authorship(DataForClassification):
    """Function-word adjacency networks: classify whether an excerpt was
    written by `authorName` (half the samples) or any other author.

    Loads `authorshipData.mat` from data_dir when present (hdf5storage
    layout: per-author word-frequency excerpts `wordFreq` and WANs `WAN`);
    otherwise generates a synthetic corpus with per-author word-transition
    signatures so the task remains well-posed (documented divergence: the
    reference ships the .mat as rar parts which are not available here).
    """

    def __init__(self, authorName, ratioTrain, ratioValid, data_dir=None,
                 rng=None, nWords=64, nExcerpts=160, nSynthAuthors=6,
                 dataType=np.float64):
        super().__init__()
        rng = np.random.default_rng() if rng is None else rng
        self.authorName = authorName
        self.dataType = dataType
        loaded = self._load(data_dir) if data_dir else None
        if loaded is None:
            loaded = self._synthesize(rng, nWords, nExcerpts, nSynthAuthors,
                                      authorName)
        self.functionWords = loaded.pop("_functionWords", None)
        self.authorData = loaded
        author = loaded[authorName]
        others = {k: v for k, v in loaded.items() if k != authorName}

        x_auth = author["wordFreq"]                   # nEx x nWords
        n_auth = x_auth.shape[0]
        # equal number of "other" excerpts, sampled uniformly across authors
        pool = np.concatenate([v["wordFreq"] for v in others.values()], axis=0)
        sel = rng.permutation(pool.shape[0])[:n_auth]
        x_rest = pool[sel]
        x = np.concatenate([x_auth, x_rest], axis=0)
        y = np.concatenate([np.ones(n_auth, np.int64),
                            np.zeros(n_auth, np.int64)])
        perm = rng.permutation(x.shape[0])
        x, y = x[perm], y[perm]
        n = x.shape[0]
        nTrain = int(round(ratioTrain * n))
        nValid = int(round(ratioValid * nTrain))
        nTrain = nTrain - nValid
        self.nTrain, self.nValid, self.nTest = nTrain, nValid, n - nTrain - nValid
        # remember which *author* excerpts landed in training (for the WAN fuse)
        self._train_indices = perm[:nTrain]
        sl = np.split(np.arange(n), [nTrain, nTrain + nValid])
        for name, idx in zip(("train", "valid", "test"), sl):
            self.samples[name]["signals"] = x[idx]
            self.samples[name]["targets"] = y[idx]
        self.astype(dataType)

    def _load(self, data_dir):
        """Parse `authorshipData.mat` in the reference's on-disk layout
        (dataTools.py:834-886): keys 'all_authors' (cell of author-name
        chars), 'all_freqs' (cell of 1 x nWords x nData), 'all_wans'
        (cell of nWords x nWords x nData), 'function_words'. Handles both
        MATLAB v5 (scipy.io) and v7.3/HDF5 (h5py) containers — the
        reference uses hdf5storage, unavailable here."""
        path = data_dir if os.path.isfile(data_dir) \
            else os.path.join(data_dir, "authorshipData.mat")
        if not os.path.exists(path):
            return None
        try:
            import scipy.io
            raw = scipy.io.loadmat(path)
            return self._parse_reference_mat(raw)
        except NotImplementedError:
            return self._parse_reference_mat73(path)

    @staticmethod
    def _unwrap_str(x) -> str:
        while isinstance(x, np.ndarray):
            if x.size == 0:
                return ""
            x = x.flat[0]
        return str(x)

    @classmethod
    def _parse_reference_mat(cls, raw):
        if "all_authors" not in raw:
            return None
        names = [cls._unwrap_str(a)
                 for a in np.asarray(raw["all_authors"]).flatten()]
        freqs = np.asarray(raw["all_freqs"]).flatten()
        wans = np.asarray(raw["all_wans"]).flatten()
        out = {}
        for i, name in enumerate(names):
            f = np.asarray(freqs[i], np.float64)
            if f.ndim == 3:                    # 1 x nWords x nData
                f = f.squeeze(0)
            f = f.T                            # nData x nWords
            w = np.asarray(wans[i], np.float64)
            w = w.transpose(2, 0, 1)           # nData x nWords x nWords
            out[name] = {"wordFreq": f, "WAN": w}
        if "function_words" in raw:
            out["_functionWords"] = [
                cls._unwrap_str(wd)
                for wd in np.asarray(raw["function_words"]).flatten()]
        return out

    @classmethod
    def _parse_reference_mat73(cls, path):
        """MATLAB v7.3 = HDF5: cell arrays are datasets of object refs,
        char arrays are uint16 codepoints, everything transposed
        (column-major)."""
        import h5py

        with h5py.File(path, "r") as f:
            def deref(x):
                # follow reference chains down to concrete arrays
                if isinstance(x, h5py.Reference):
                    return deref(f[x])
                arr = np.asarray(x)
                if arr.dtype.kind == "O":      # dataset of object refs
                    items = [deref(r) for r in arr.flatten()]
                    return items if len(items) != 1 else items[0]
                return arr

            def as_str(a):
                while isinstance(a, list):
                    a = a[0]
                a = np.asarray(a)
                if a.dtype.kind in ("u", "i"):
                    return "".join(chr(int(c)) for c in a.flatten())
                return cls._unwrap_str(a)

            def cell(name):
                items = deref(f[name])
                return items if isinstance(items, list) else [items]

            names = [as_str(c) for c in cell("all_authors")]
            freqs = cell("all_freqs")
            wans = cell("all_wans")
            out = {}
            for i, name in enumerate(names):
                # HDF5 stores matlab arrays with reversed axes
                fq = np.asarray(freqs[i], np.float64)
                fq = fq.transpose(tuple(reversed(range(fq.ndim))))
                if fq.ndim == 3:               # back to 1 x nWords x nData
                    fq = fq.squeeze(0)
                fq = fq.T
                w = np.asarray(wans[i], np.float64)
                w = w.transpose(tuple(reversed(range(w.ndim))))
                w = w.transpose(2, 0, 1)
                out[name] = {"wordFreq": fq, "WAN": w}
            if "function_words" in f:
                out["_functionWords"] = [as_str(c)
                                         for c in cell("function_words")]
            return out

    @staticmethod
    def _synthesize(rng, nWords, nExcerpts, nAuthors, authorName):
        names = [authorName] + [f"author{i}" for i in range(1, nAuthors)]
        data = {}
        for name in names:
            # author-specific word-transition signature
            base = rng.random((nWords, nWords)) * (rng.random((nWords, nWords))
                                                   < 0.15)
            np.fill_diagonal(base, 0)
            freqs, wans = [], []
            for _ in range(nExcerpts):
                noise = rng.random((nWords, nWords)) * 0.2
                wan = base + noise * (base > 0)
                wans.append(wan)
                freqs.append(wan.sum(axis=1) + 0.05 * rng.random(nWords))
            data[name] = {"wordFreq": np.stack(freqs),
                          "WAN": np.stack(wans)}
        return data

    def createGraph(self):
        """Fuse the training-set WANs of the target author into one graph
        (reference dataTools.py:938-977: fuseEdges with row normalization,
        undirected, largest connected component)."""
        wans = self.authorData[self.authorName]["WAN"]
        node_list: list = []
        W = gt.create_graph("fuseEdges", wans.shape[1], {
            "adjacencyMatrices": wans,
            "aggregationType": "sum",
            "normalizationType": "rows",
            "isolatedNodes": False,
            "forceUndirected": True,
            "forceConnected": True,
            "nodeList": node_list,
        })
        self.nodeList = node_list
        self.adjacencyMatrix = W
        # restrict signals to surviving nodes
        for t in ("train", "valid", "test"):
            self.samples[t]["signals"] = \
                self.samples[t]["signals"][..., node_list]
        return W

    create_graph = createGraph


# ---------------------------------------------------------------------------
# MovieLens-100k (reference dataTools.py:1014-2209)
# ---------------------------------------------------------------------------

class MovieLens(Data):
    """Rating prediction at target node(s) on a similarity graph built from
    **training ratings only** (Pearson-style correlation, kNN-sparsified).

    graphType 'movie': nodes are movies, each sample is a user's rating row.
    Loads ml-100k `u.data` from data_dir; synthetic low-rank fallback keeps
    the task testable offline.
    """

    def __init__(self, graphType, labelID, ratioTrain, ratioValid,
                 data_dir=None, keepIsolatedNodes=False, forceUndirected=True,
                 forceConnected=True, kNN=10, maxNodes=None, minRatings=0,
                 interpolate=False, dataType=np.float64, rng=None,
                 nSynthUsers=200, nSynthMovies=120):
        super().__init__()
        rng = np.random.default_rng() if rng is None else rng
        if graphType not in ("user", "movie"):
            raise ValueError(f"graphType must be 'user' or 'movie', got "
                             f"{graphType!r}")
        if isinstance(labelID, int):
            labelID = [labelID]
        self.graphType = graphType
        self.dataType = dataType
        self.kNN = kNN

        M = self._load(data_dir)
        if M is None:
            M = self._synthesize(rng, nSynthUsers, nSynthMovies)
        # orient: rows = samples, cols = nodes
        if graphType == "user":
            M = M.T                                   # rows: movies as samples
        # drop rows/cols with too few ratings
        if minRatings > 0:
            keep_c = (M > 0).sum(0) >= minRatings
            M = M[:, keep_c]
            keep_r = (M > 0).sum(1) >= minRatings
            M = M[keep_r]
        if maxNodes is not None and maxNodes < M.shape[1]:
            top = np.argsort(-(M > 0).sum(0))[:maxNodes]
            M = M[:, np.sort(top)]
        self.incompleteMatrix = M
        n_nodes = M.shape[1]
        self.labelID = [int(l) for l in labelID]

        # samples: rows that have a rating at (any of) labelID
        lid = self.labelID[0]
        has_label = np.flatnonzero(M[:, lid] > 0)
        perm = rng.permutation(len(has_label))
        has_label = has_label[perm]
        n = len(has_label)
        nTrain = int(round(ratioTrain * n))
        nValid = int(round(ratioValid * nTrain))
        nTrain = nTrain - nValid
        self.nTrain, self.nValid, self.nTest = nTrain, nValid, n - nTrain - nValid
        split = {"train": has_label[:nTrain],
                 "valid": has_label[nTrain:nTrain + nValid],
                 "test": has_label[nTrain + nValid:]}
        self.indexDataPoints = dict(split)
        self.indexDataPoints["all"] = has_label

        self.targetIDs = {}
        for name, idx in split.items():
            sig = M[idx].copy()
            tgt = sig[:, lid].copy()
            sig[:, lid] = 0.0
            self.samples[name]["signals"] = sig
            self.samples[name]["targets"] = tgt
            self.targetIDs[name] = np.full(len(idx), lid, np.int64)

        # graph from training ratings only
        self.adjacencyMatrix = self._create_graph(
            M, split["train"], keepIsolatedNodes, forceUndirected,
            forceConnected, kNN)
        self.astype(dataType)

    # -- loading -----------------------------------------------------------
    @staticmethod
    def _load(data_dir):
        if data_dir is None:
            return None
        for sub in ("", "ml-100k"):
            path = os.path.join(data_dir, sub, "u.data")
            if os.path.exists(path):
                raw = np.loadtxt(path, dtype=np.int64)
                n_users = raw[:, 0].max()
                n_movies = raw[:, 1].max()
                M = np.zeros((n_users, n_movies))
                M[raw[:, 0] - 1, raw[:, 1] - 1] = raw[:, 2]
                return M
        return None

    @staticmethod
    def _synthesize(rng, n_users, n_movies, rank=5, density=0.15):
        U = rng.random((n_users, rank))
        V = rng.random((n_movies, rank))
        full = U @ V.T
        full = 1 + 4 * (full - full.min()) / (full.max() - full.min())
        mask = rng.random((n_users, n_movies)) < density
        return np.round(full * mask * 2) / 2.0 * mask

    # -- graph -------------------------------------------------------------
    def _create_graph(self, M, train_rows, keep_isolated, force_undirected,
                      force_connected, kNN):
        """Pearson-style correlation between node columns over co-rated
        training entries, kNN sparsified (reference dataTools.py:1814-1905)."""
        W = np.zeros_like(M)
        W[train_rows] = M[train_rows]                 # training ratings only
        Wt = W.T                                      # nodes x samples
        template = (Wt > 0).astype(np.float64)
        sum_m = Wt @ template.T
        count = template @ template.T
        count[count == 0] = 1
        avg = sum_m / count
        sq_sum = (Wt ** 2) @ template.T
        corr = sq_sum / count - avg ** 2
        sqrt_diag = np.sqrt(np.diag(corr).clip(0))
        nz = (sqrt_diag > ZERO_TOL).astype(np.float64)
        sqrt_diag[sqrt_diag < ZERO_TOL] = 1.0
        inv = (1.0 / sqrt_diag) * nz
        norm = np.diag(inv)
        A = norm @ corr @ norm
        np.fill_diagonal(A, 0)
        A[A < 0] = 0  # keep similarity graph nonnegative
        A = gt.sparsify_graph(A, "NN", kNN)
        node_list: list = []
        A = gt.create_graph("fuseEdges", A.shape[0], {
            "adjacencyMatrices": A[None],
            "aggregationType": "sum", "normalizationType": "no",
            "isolatedNodes": keep_isolated,
            "forceUndirected": force_undirected,
            "forceConnected": force_connected,
            "nodeList": node_list})
        if len(node_list) < M.shape[1]:
            # restrict samples + labelID to the surviving nodes
            remap = {old: new for new, old in enumerate(node_list)}
            lid = self.labelID[0]
            if lid not in remap:
                raise ValueError(f"labelID node {lid} dropped by graph "
                                 "construction")
            self.labelID = [remap[lid]]
            for t in ("train", "valid", "test"):
                self.samples[t]["signals"] = \
                    self.samples[t]["signals"][:, node_list]
                self.targetIDs[t] = np.full(len(self.targetIDs[t]),
                                            remap[lid], np.int64)
        self.nodeList = node_list
        return A

    def interpolateRatings(self):
        """Nearest-neighbor interpolation of missing ratings: every zero in
        a graph signal (except the held-out labelID node) is replaced by the
        mean rating of its nearest rated neighbors on the similarity graph
        (reference dataTools.py:2019-2109)."""
        A = self.adjacencyMatrix
        lid = self.labelID[0]
        for t in ("train", "valid", "test"):
            sig = self.samples[t]["signals"]
            flat = sig if sig.ndim == 2 else sig[:, 0]
            for s in range(flat.shape[0]):
                row = flat[s]
                missing = np.flatnonzero((row == 0))
                for m in missing:
                    if m == lid:
                        continue
                    nbrs = np.flatnonzero(A[m] > 0)
                    rated = nbrs[row[nbrs] > 0]
                    if len(rated):
                        row[m] = row[rated].mean()
            if sig.ndim == 3:
                self.samples[t]["signals"][:, 0] = flat
            else:
                self.samples[t]["signals"] = flat

    interpolate_ratings = interpolateRatings

    def getGraph(self):
        return self.adjacencyMatrix

    def getIncompleteMatrix(self):
        return self.incompleteMatrix

    def getLabelID(self, *args):
        """Per-sample target node ids (reference dataTools.py:2122-2162)."""
        if len(args) == 0:
            return self.labelID
        samplesType = args[0]
        ids = self.targetIDs[samplesType]
        if len(args) == 2:
            if isinstance(args[1], int):
                sel = np.random.choice(len(ids), size=args[1], replace=False)
                return ids[sel]
            return ids[np.asarray(args[1])]
        return ids

    get_label_id = getLabelID

    def evaluate(self, yHat, y):
        """RMSE (reference dataTools.py:2164-2187)."""
        yHat = np.asarray(yHat).squeeze()
        y = np.asarray(y).squeeze()
        return float(np.sqrt(np.mean((yHat - y) ** 2)))


# ---------------------------------------------------------------------------
# Epidemics (SIR on the SocioPatterns friendship graph)
# (reference dataTools.py:4534-4651)
# ---------------------------------------------------------------------------

class Epidemics(Data):
    """SIR simulation: seed infections w.p. seedProb; infected neighbors
    transmit w.p. infectionProb * t/horizon; recovery after recoveryTime
    steps. x = states over the first seqLen steps, y = infected-indicator
    over the last seqLen steps; evaluate = 1 - F1 on the infected class.

    Documented divergences from the reference (SURVEY.md §7): we fix its
    `==`-instead-of-`=` infection update (dataTools.py:4574), its
    `Adj[i, i:]` neighbor-offset slip, and its state aliasing — i.e. we run
    the SIR process the docstring describes.
    """

    def __init__(self, seqLen, seedProb, infectionProb, recoveryTime,
                 nTrain, nValid, nTest, x0=None, data_dir=None,
                 dataType=np.float64, rng=None, nSynthNodes=120):
        super().__init__()
        rng = np.random.default_rng() if rng is None else rng
        self.seqLen = seqLen
        self.dataType = dataType
        self.nTrain, self.nValid, self.nTest = nTrain, nValid, nTest
        nSamples = nTrain + nValid + nTest
        self.Adj = self.createGraph(data_dir, rng, nSynthNodes)
        N = self.Adj.shape[0]
        self.N = N

        if x0 is None:
            x0 = rng.binomial(1, seedProb, (nSamples, N))
            while np.sum(x0.sum(axis=1) > 0) < nSamples:
                x0 = rng.binomial(1, seedProb, (nSamples, N))
        self.x0 = x0

        horizon = 2 * seqLen
        x_t = x0.astype(np.int64)
        xs = [x_t.copy()]
        time_infected = np.where(x_t == 1, 0, -1)     # step of infection
        for t in range(1, horizon):
            infected = x_t == 1
            # pressure: number of infected neighbors
            n_inf_nbrs = infected @ self.Adj.astype(np.int64)
            p = infectionProb * t / horizon
            catch = (rng.random((nSamples, N)) <
                     1 - (1 - p) ** np.maximum(n_inf_nbrs, 0))
            newly = (x_t == 0) & (n_inf_nbrs > 0) & catch
            recover = infected & (t - time_infected >= recoveryTime)
            x_next = x_t.copy()
            x_next[newly] = 1
            time_infected[newly] = t
            x_next[recover] = 2
            x_t = x_next
            xs.append(x_t.copy())
        x = np.stack(xs, axis=1)                      # nSamples x horizon x N
        y = (x[:, seqLen:horizon, :] == 1).astype(np.int64)
        x = x[:, :seqLen, :].astype(np.float64)
        sl = np.split(np.arange(nSamples), [nTrain, nTrain + nValid])
        for name, idx in zip(("train", "valid", "test"), sl):
            self.samples[name]["signals"] = x[idx]
            self.samples[name]["targets"] = y[idx]
        self.astype(dataType)

    @staticmethod
    def createGraph(data_dir=None, rng=None, n_synth=120):
        """Load the SocioPatterns high-school friendship edge list
        (tab-separated, 1-indexed), symmetrize, drop isolated nodes
        (reference dataTools.py:4593-4613); SBM fallback."""
        candidates = []
        if data_dir:
            candidates.append(os.path.join(data_dir, "edge_list.txt"))
            candidates.append(os.path.join(data_dir, "epidemics",
                                           "edge_list.txt"))
        for path in candidates:
            if os.path.exists(path):
                edges = []
                with open(path) as f:
                    for row in csv.reader(f, delimiter="\t"):
                        edges.append((int(row[0]) - 1, int(row[1]) - 1))
                n = max(max(e) for e in edges) + 1
                A = np.zeros((n, n))
                for i, j in edges:
                    A[i, j] = 1
                A = ((A + A.T) > 0).astype(np.float64)
                keep = np.flatnonzero(A.sum(axis=1) > 0)
                return A[np.ix_(keep, keep)]
        rng = np.random.default_rng(0) if rng is None else rng
        return gt.create_graph("SBM", n_synth,
                               {"nCommunities": 4, "probIntra": 0.1,
                                "probInter": 0.01}, rng=rng)

    create_graph = createGraph

    def evaluate(self, yHat, y, tol: float = 1e-9) -> float:
        """1 - F1 on the infected class; yHat are 2-class logits
        (..., 2, N). Reference dataTools.py:4615-4648."""
        yHat = np.asarray(yHat)
        y = np.asarray(y)
        C = yHat.shape[-2]
        N = yHat.shape[-1]
        yHat = yHat.reshape(-1, C, N)
        pred = np.argmax(yHat, axis=1).astype(np.float64)
        y = y.reshape(-1, N).astype(np.float64)
        tp = np.sum(y * pred, axis=1)
        fp = np.sum((1 - y) * pred, axis=1)
        fn = np.sum(y * (1 - pred), axis=1)
        with np.errstate(invalid="ignore", divide="ignore"):
            p = tp / (tp + fp)
            r = tp / (tp + fn)
        # NaN handling per reference: no positives anywhere -> perfect score
        p = np.where(np.isnan(p), np.where(tp < tol, 1.0, 0.0), p)
        p = np.where((tp + fp == 0) & (tp >= tol), 0.0, p)
        r = np.where(np.isnan(r), np.where(tp < tol, 1.0, 0.0), r)
        with np.errstate(invalid="ignore", divide="ignore"):
            f1 = 2 * p * r / (p + r)
        f1 = np.where(np.isnan(f1), 0.0, f1)
        return float(1 - np.mean(f1))


# ---------------------------------------------------------------------------
# FacebookEgo (reference dataTools.py:343-471)
# ---------------------------------------------------------------------------

class FacebookEgo:
    """McAuley-Leskovec ego-Facebook graph; loads the preprocessed 234-node
    two-community subgraph pickle when available."""

    def __init__(self, data_dir=None, use234=True):
        self.adjacencyMatrix = None
        candidates = []
        if data_dir:
            candidates += [
                os.path.join(data_dir, "facebookEgo234.pkl"),
                os.path.join(data_dir, "facebookEgo", "facebookEgo234.pkl"),
            ]
        for path in candidates:
            if os.path.exists(path) and use234:
                with open(path, "rb") as f:
                    obj = pickle.load(f)
                self.adjacencyMatrix = np.asarray(
                    obj if isinstance(obj, np.ndarray) else obj.get("adjacencyMatrix", obj))
                break
        if self.adjacencyMatrix is None:
            # synthetic 2-community stand-in
            self.adjacencyMatrix = gt.create_graph(
                "SBM", 234, {"nCommunities": 2, "probIntra": 0.15,
                             "probInter": 0.01},
                rng=np.random.default_rng(0))

    def getAdjacencyMatrix(self, use234: bool = True):
        return self.adjacencyMatrix

    get_adjacency_matrix = getAdjacencyMatrix


# ---------------------------------------------------------------------------
# TwentyNews (legacy; reference dataTools.py:4006-4533)
# ---------------------------------------------------------------------------

def distance_sklearn_metrics(z: np.ndarray, k: int = 4,
                             metric: str = "euclidean"):
    """k-nearest-neighbor distances and indices between row vectors
    (reference dataTools.py helper for the 20NEWS word graph)."""
    from sklearn.metrics import pairwise_distances
    d = pairwise_distances(z, metric=metric)
    idx = np.argsort(d)[:, 1:k + 1]
    d.sort()
    return d[:, 1:k + 1], idx


def knn_adjacency(dist: np.ndarray, idx: np.ndarray):
    """Gaussian-kernel kNN adjacency from distance_sklearn_metrics output:
    W_ij = exp(-d_ij^2 / sigma^2), symmetrized by max (reference
    dataTools.py `adjacency`)."""
    M, k = dist.shape
    sigma2 = np.mean(dist[:, -1]) ** 2
    w = np.exp(-dist ** 2 / sigma2)
    W = np.zeros((M, M))
    rows = np.repeat(np.arange(M), k)
    W[rows, idx.ravel()] = w.ravel()
    W = np.maximum(W, W.T)
    np.fill_diagonal(W, 0)
    return W


def replace_random_edges(A: np.ndarray, noise_level: float, rng=None):
    """Randomly rewire a fraction of edges (robustness experiments;
    reference dataTools.py `replace_random_edges`)."""
    rng = np.random.default_rng() if rng is None else rng
    A = A.copy()
    M = A.shape[0]
    n_replace = int(noise_level * (np.count_nonzero(np.triu(A))))
    for _ in range(n_replace):
        ii = np.transpose(np.nonzero(np.triu(A)))
        if not len(ii):
            break
        kill = ii[rng.integers(len(ii))]
        A[kill[0], kill[1]] = A[kill[1], kill[0]] = 0
        i, j = rng.integers(M, size=2)
        if i != j:
            A[i, j] = A[j, i] = 1.0
    return A


class TwentyNews(DataForClassification):
    """20NEWS word-graph classification. The reference embeds words with a
    downloaded word2vec model and fetches the corpus via sklearn — both need
    network access. Here: loads a preprocessed npz (x_train, y_train,
    x_test, y_test, adjacency) from data_dir, else a synthetic word-graph
    corpus."""

    def __init__(self, ratioValid=0.1, data_dir=None, rng=None, nWords=80,
                 nClasses=5, nPerClass=100, dataType=np.float64):
        super().__init__()
        rng = np.random.default_rng() if rng is None else rng
        self.dataType = dataType
        path = data_dir and os.path.join(data_dir, "twentynews.npz")
        if path and os.path.exists(path):
            z = np.load(path)
            x_train, y_train = z["x_train"], z["y_train"]
            x_test, y_test = z["x_test"], z["y_test"]
            self.adjacencyMatrix = z["adjacency"]
        else:
            # synthetic: class-dependent word co-occurrence
            W = gt.create_graph("SBM", nWords,
                                {"nCommunities": nClasses, "probIntra": 0.3,
                                 "probInter": 0.02}, rng=rng)
            self.adjacencyMatrix = W
            protos = rng.random((nClasses, nWords)) * 0.2
            sizes = nWords // nClasses
            for c in range(nClasses):
                protos[c, c * sizes:(c + 1) * sizes] += 1.0
            n = nClasses * nPerClass
            y = np.repeat(np.arange(nClasses), nPerClass)
            x = protos[y] + 0.3 * rng.random((n, nWords))
            perm = rng.permutation(n)
            x, y = x[perm], y[perm]
            n_test = n // 5
            x_train, y_train = x[:-n_test], y[:-n_test]
            x_test, y_test = x[-n_test:], y[-n_test:]
        nValid = int(round(ratioValid * x_train.shape[0]))
        self.nTrain = x_train.shape[0] - nValid
        self.nValid = nValid
        self.nTest = x_test.shape[0]
        self.samples["train"]["signals"] = x_train[:self.nTrain]
        self.samples["train"]["targets"] = y_train[:self.nTrain]
        self.samples["valid"]["signals"] = x_train[self.nTrain:]
        self.samples["valid"]["targets"] = y_train[self.nTrain:]
        self.samples["test"]["signals"] = x_test
        self.samples["test"]["targets"] = y_test
        self.astype(dataType)

    def getGraph(self):
        return self.adjacencyMatrix
