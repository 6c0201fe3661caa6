"""Serving: a fixed-batch forward for ragged request batches, bf16
serving, introspection, and a self-contained exported program.

The counterpart of the JAX package's ``serving.py``:

  * :class:`InferenceEngine` -- one batch size is fixed at construction; a
    request of fewer rows is zero-padded up to it, leaf by leaf (an
    ``ops.ell.EllGso`` argument too: it is a pytree), and the answer sliced
    back; a larger request is refused. The forward runs eagerly under
    ``torch.inference_mode()`` on the architecture's device. A static-GSO
    model answers ``engine(x)``, a time-varying (DB family) one
    ``engine(x, S)`` with S a dense (B, T, [E,] N, N) stack, an EllGso or
    a ``parallel.ShardedEllGso`` (also a pytree; padded and cast leaf by
    leaf, still sharded).
    ``dtype=torch.bfloat16`` serves a bf16 copy of the model (parameters,
    float inputs and the GSO's float tensors in bf16, on the bf16
    instances of the kernels); outputs are f32 either way. A GRNN's core
    runs on its bf16 context with z0 drawn as the f32 engine draws it and
    rounded to bf16; MultiNodeAggregationGNN computes in f32 on its bf16
    parameters, as JAX's engine does.
  * ``cost_analysis``/``memory_analysis``/``flops_per_sample`` -- flops of
    one padded batch from ``FlopCounterMode`` (the kernels' ops carry flop
    formulas), bytes of its arguments (parameters included, as the JAX
    compiled call takes them), outputs and peak temporaries.
  * :func:`export_model`/:func:`load_exported` -- the forward as a
    ``torch.export`` program with the weights and the GSO structure inside,
    saved with ``torch.export.save``; reloading needs only the modules that
    register the kernels' ops (``ops.spmm``, ``ops.attention_flash``) and
    the EllGso pytree (``ops.ell``), not the model code.
"""

from __future__ import annotations

import copy
import dataclasses
import io
from typing import Any, Optional, Sequence

import torch
from torch import nn
from torch.utils import _pytree
from torch.utils.flop_counter import FlopCounterMode

from graph_neural_networks_torch.ops import ell as _ell
from graph_neural_networks_torch.ops import gso as gso_lib
from graph_neural_networks_torch.utils.device import resolve_device

__all__ = ["InferenceEngine", "MemoryAnalysis", "export_model",
           "load_exported"]

_DTYPES = (None, torch.float32, torch.bfloat16)


def _compute_dtype(dtype) -> torch.dtype:
    if dtype not in _DTYPES:
        raise ValueError(f"dtype must be one of {_DTYPES}, got {dtype!r}")
    return torch.float32 if dtype is None else dtype


def _inputs(args: Sequence[Any], device, dtype) -> tuple:
    """Every leaf of every argument as a tensor on `device`, the float ones
    in `dtype` (the integer ones, an EllGso's idx, kept)."""
    def leaf(a):
        t = torch.as_tensor(a, device=device)
        return t.to(dtype) if t.is_floating_point() else t
    return tuple(_pytree.tree_map(leaf, arg) for arg in args)


def _pad(t: torch.Tensor, B: int) -> torch.Tensor:
    n = t.shape[0]
    if n == B:
        return t
    return torch.cat([t, t.new_zeros((B - n,) + tuple(t.shape[1:]))])


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in _pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _as_f32(y):
    return _pytree.tree_map(
        lambda a: a.float() if a.is_floating_point() else a, y)


def _served_copy(arch, dtype):
    """The architecture the engine runs: `arch` itself in f32; in bf16 a
    copy with its parameters and the float tensors of its context (the
    GSO's, with its cached band structure; a ShardedGso's twin; an
    EdgeList's s_val) in bf16. MultiNodeAggregationGNN's inner contexts
    stay f32, as JAX's. The caller's model is never cast."""
    if dtype == torch.float32:
        return arch
    if isinstance(arch, nn.Module):   # the DB family: weights only
        return copy.deepcopy(arch).to(dtype=dtype)
    from graph_neural_networks_torch.models import architectures as archs
    if isinstance(arch, archs.MultiNodeAggregationGNN):
        served = copy.deepcopy(arch)
        served.core.to(dtype=dtype)
        return served
    served = copy.copy(arch)
    served.core = copy.deepcopy(arch.core).to(dtype=dtype)
    served.ctx = {k: gso_lib.cast_ctx(v, dtype) for k, v in arch.ctx.items()}
    served.S = served.ctx.get("S")
    return served


def _forward_fn(arch, dtype):
    """The raw forward (the JAX ``_forward_fn``): ``arch.apply`` in f32
    (and for the DB family, ``apply(x, S)``). In bf16 the core on the
    static context, since ``apply`` computes in f32; a GRNN's core on z0
    drawn as ``apply`` draws it (a fresh generator seeded 0, the padded
    batch's rows) and rounded to bf16; MultiNodeAggregationGNN, whose
    JAX forward casts x to f32 against bf16 parameters, ``apply`` on its
    parameters taken as f32 (torch does not promote a bf16 x f32
    product)."""
    if dtype == torch.float32 or isinstance(arch, nn.Module):
        return arch.apply
    from graph_neural_networks_torch.models import architectures as archs
    core = arch.core
    if isinstance(arch, archs.MultiNodeAggregationGNN):
        from graph_neural_networks_torch.training.trainer import _Bound
        bound = _Bound(core, arch.apply)

        def forward(x):
            params = {f"module.{n}": p.float()
                      for n, p in core.named_parameters()}
            return torch.func.functional_call(bound, params, (x,))
        return forward
    ctx = arch.ctx
    if isinstance(arch, archs.GraphRecurrentNN):
        return lambda x: core(x, arch.draw_z0(x.shape[0], x.shape[-1]).to(
            dtype), ctx)[0]
    return lambda x: core(x, ctx)[0]


def _modules(arch) -> nn.Module:
    """The module holding the served architecture's parameters."""
    return arch if isinstance(arch, nn.Module) else arch.core


def _build_band_structure(arch) -> None:
    """Build a band-mode attention model's band structure now (it is cached
    on the GSO at first use): before an export traces the forward."""
    from graph_neural_networks_torch.ops import attention_flash
    S = getattr(arch, "ctx", {}).get("S")
    if isinstance(S, gso_lib.Gso) and S.mode == "band" and getattr(
            getattr(arch, "core", None), "filter_kind", None) in (
                "gat", "gcat", "ev_attention"):
        attention_flash.band_auxes(S)


@dataclasses.dataclass
class MemoryAnalysis:
    """Bytes of one padded batch, under the JAX compiled call's field
    names: its arguments (the parameters included), its outputs, and the
    forward's temporaries (``None`` on the CPU, which keeps no peak)."""
    argument_size_in_bytes: int
    output_size_in_bytes: int
    temp_size_in_bytes: Optional[int]


class InferenceEngine:
    """Fixed-shape forward for serving one architecture.

    arch: a ported architecture: the static-GSO ones (SelectionGNN,
    LocalGNN, the attention family, ...; request ``engine(x)``) and the DB
    family (LocalGNN_DB, GraphRecurrentNN_DB, AggregationGNN_DB; request
    ``engine(x, S)``). It is moved to `device` in place, parameters and
    structure tables. A band-mode attention model builds its band
    structure (``attention_flash.band_auxes``) at the first request and
    keeps it on the GSO.

    dtype: None (f32) or torch.bfloat16, which serves a bf16 copy of the
    architecture and of its GSO (the JAX ``_cast_floats`` of params, float
    inputs and ctx) on the bf16 kernels; outputs return as f32. A sharded
    architecture serves on its ShardedGso's bf16 twin
    (``ShardedGso.to(dtype=)``) and the bf16 ext kernels. A GRNN
    (request ``engine(x)``, z0 drawn for the padded batch from a generator
    seeded 0, as in f32) runs its core in bf16, which JAX's engine runs on
    the request ``(x, z0)``; MultiNodeAggregationGNN computes in f32 on
    the bf16-rounded request and parameters, as JAX's.

    example_args: one example request (unpadded), so that the
    introspection can run before the first request; without it, it uses
    the shapes of the last request.
    """

    def __init__(self, arch, batch_size: int, device="cuda", dtype=None,
                 example_args: Optional[Sequence[Any]] = None):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.dtype = dtype
        self._cdt = _compute_dtype(dtype)
        self.device = resolve_device(device)
        self.arch = arch.to(self.device)
        self.batch_size = int(batch_size)
        self._served = _served_copy(self.arch, self._cdt)
        self._forward = _forward_fn(self._served, self._cdt)
        self._spec = None
        if example_args is not None:
            self._padded(tuple(example_args))

    def _padded(self, args: tuple):
        """(request rows n, the arguments padded to the batch size)."""
        args = _inputs(args, self.device, self._cdt)
        n = _pytree.tree_leaves(args[0])[0].shape[0]
        B = self.batch_size
        if n > B:
            raise ValueError(f"request batch {n} exceeds the engine's batch "
                             f"size {B}")
        padded = tuple(_pytree.tree_map(lambda t: _pad(t, B), arg)
                       for arg in args)
        leaves, spec = _pytree.tree_flatten(padded)
        self._spec = spec, [(t.shape, t.dtype) for t in leaves]
        return n, padded

    def __call__(self, *args):
        """Answer one request: x (n, F0, N), or (x, S) for the DB family,
        n <= batch_size; f32 outputs of n rows."""
        n, padded = self._padded(args)
        with torch.inference_mode():
            y = self._forward(*padded)
        return _pytree.tree_map(lambda a: a[:n], _as_f32(y))

    # -- introspection -------------------------------------------------------
    def _example(self) -> tuple:
        if self._spec is None:
            raise RuntimeError("no request shape yet: pass example_args= or "
                               "answer a request first")
        spec, leaves = self._spec
        return _pytree.tree_unflatten(
            [torch.zeros(shape, dtype=dt, device=self.device)
             for shape, dt in leaves], spec)

    def _param_bytes(self) -> int:
        return _nbytes(list(_modules(self._served).parameters()))

    def cost_analysis(self) -> dict:
        """Flops and bytes of one padded batch: ``"flops"`` from
        ``FlopCounterMode`` over one forward (the GEMMs and einsums, and the
        kernels' ops by their registered formulas), ``"bytes accessed"``
        the bytes of the arguments, parameters and outputs."""
        args = self._example()
        with torch.inference_mode(), FlopCounterMode(display=False) as fc:
            y = _as_f32(self._forward(*args))
        return {"flops": float(fc.get_total_flops()),
                "bytes accessed": float(_nbytes(args) + self._param_bytes()
                                        + _nbytes(y))}

    def memory_analysis(self) -> MemoryAnalysis:
        """Argument bytes (the padded batch and the parameters), output
        bytes (f32) and, on CUDA, the temporaries: the peak of
        ``torch.cuda.max_memory_allocated`` over one forward less what was
        resident before it (None on the CPU)."""
        args = self._example()
        temp = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            base = torch.cuda.memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        with torch.inference_mode():
            y = _as_f32(self._forward(*args))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            temp = torch.cuda.max_memory_allocated(self.device) - base
        return MemoryAnalysis(_nbytes(args) + self._param_bytes(),
                              _nbytes(y), temp)

    def flops_per_sample(self) -> float:
        return self.cost_analysis()["flops"] / self.batch_size


class _Program(nn.Module):
    """What export_model traces: the served forward, outputs cast to f32;
    the parameters registered as the submodule's, so they go into the
    program as its weights (the GSO's tensors as its constants)."""

    def __init__(self, held: nn.Module, fn):
        super().__init__()
        self.held = held
        self.fn = fn

    def forward(self, *args):
        return _as_f32(self.fn(*args))


def export_model(arch, example_args: Sequence[Any],
                 path: Optional[str] = None, dtype=None,
                 device="cuda") -> bytes:
    """Export the forward at `example_args`' shapes as a self-contained
    ``torch.export`` program (``strict=False``; the weights and the GSO
    structure inside) and return it serialized by ``torch.export.save``;
    also written to `path` if given. dtype=torch.bfloat16 exports the bf16
    copy (the program then takes bf16 float inputs). A band-mode attention
    model's band structure is built before tracing. Reload with
    :func:`load_exported`."""
    cdt = _compute_dtype(dtype)
    dev = resolve_device(device)
    served = _served_copy(arch.to(dev), cdt)
    _build_band_structure(served)
    args = _inputs(tuple(example_args), dev, cdt)
    program = _Program(_modules(served), _forward_fn(served, cdt))
    with torch.no_grad():
        exported = torch.export.export(program, args, strict=False)
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    blob = buf.getvalue()
    if path is not None:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def load_exported(path_or_bytes):
    """Load an :func:`export_model` artifact (a path or its bytes); returns
    a callable forward taking the exported shapes. Each leaf is moved to
    the device, and a float one cast to the dtype, of the program's example
    input (numpy arrays are taken). Imports the kernels' op registrations
    and the EllGso pytree, never the model code."""
    from graph_neural_networks_torch.ops import attention_flash  # noqa: F401
    from graph_neural_networks_torch.ops import spmm  # noqa: F401
    blob = path_or_bytes
    if isinstance(blob, str):
        with open(blob, "rb") as f:
            blob = f.read()
    with torch.serialization.safe_globals([_ell.EllGso]):
        exported = torch.export.load(io.BytesIO(blob))
    module = exported.module()
    examples = _pytree.tree_leaves(exported.example_inputs[0])

    def leaf(a, example):
        t = torch.as_tensor(a, device=example.device)
        return t.to(example.dtype) if t.is_floating_point() else t

    def forward(*args):
        leaves, spec = _pytree.tree_flatten(args)
        leaves = [leaf(a, e) for a, e in zip(leaves, examples)]
        with torch.no_grad():
            return module(*_pytree.tree_unflatten(leaves, spec))
    return forward
