"""Task datasets: source localization (the port's copy of
``SourceLocalization`` of the JAX package's ``data/datasets.py``; reference
``alegnn/utils/dataTools.py:473-592``). The other tasks come with their
trainers."""

from __future__ import annotations

import numpy as np

from graph_neural_networks_torch.data.base import (DataForClassification,
                                                   ZERO_TOL)
from graph_neural_networks_torch.utils import graph as gt


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
