"""ELL (padded in-neighbor) layout for time-varying batched GSOs.

The port of the JAX package's ``ops/ell.py`` container: a fixed-width
padded in-neighbor table, the ELLPACK layout --

  * ``idx``: ``(*L, N, D)`` int32 -- ``idx[..., m, d]`` is the d-th
    in-neighbor ``n`` of output node ``m`` (entries beyond the true
    in-degree carry weight 0),
  * ``val``: ``(*L, E, N, D)`` -- ``val[..., e, m, d] = S[..., e, n, m]``
    with ``n = idx[..., m, d]``,

where ``*L`` are leading (batch/time) axes shared by both. The grid
environment's rollouts return their graph trajectory in it. The shifts
over it (``ell_shift``, ``ell_shift_rows``) are not ported yet: only the
unfused step path needs them (ROADMAP queue 1).
"""

from __future__ import annotations

__all__ = ["EllGso"]


class EllGso:
    """Padded in-neighbor (ELLPACK) time-varying GSO; see module docstring.

    idx: (*L, N, D) integer, val: (*L, E, N, D), numpy arrays or tensors.
    """

    def __init__(self, idx, val):
        if not (tuple(idx.shape[:-2]) == tuple(val.shape[:-3])
                and tuple(idx.shape[-2:]) == tuple(val.shape[-2:])):
            raise ValueError(f"EllGso: idx {tuple(idx.shape)} does not fit "
                             f"val {tuple(val.shape)}")
        self.idx = idx
        self.val = val
