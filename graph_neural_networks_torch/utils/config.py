"""Typed experiment configs and the architecture registry: the port's copy
of the JAX package's ``utils/config.py``.

The reference locates models with ``eval('model'+name)``
(sourceLocGNN.py:704); here the architectures are an explicit registry
(every class in the ``__all__`` of the port's ``models/architectures.py``
and ``models/architectures_time.py``, the same names as the JAX registry),
and experiment configuration is a typed dataclass tree that round-trips
through the same JSON as the JAX package's:

    cfg = ExperimentConfig(
        name="sourceloc",
        model=ModelConfig(architecture="SelectionGNN",
                          kwargs={"dimNodeSignals": [1, 32, 32], ...}),
        training=TrainingConfig(nEpochs=40, batchSize=100, lr=1e-3))
    arch = cfg.model.build(S, device="cuda")
    cfg.save("experiments/sourceloc/config.json")
    cfg2 = ExperimentConfig.load(...)     # identical

Unknown keys and wrong types fail at load time, not deep inside a run.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Type

# ---------------------------------------------------------------------------
# Registries (no eval())
# ---------------------------------------------------------------------------

_ARCHITECTURES: Dict[str, Type] = {}


def register_architecture(cls=None, *, name: Optional[str] = None):
    """Class decorator / direct call: register an architecture by name."""
    def do(c):
        _ARCHITECTURES[name or c.__name__] = c
        return c
    return do(cls) if cls is not None else do


def get_architecture(name: str) -> Type:
    """Resolve an architecture class by its registered (class) name."""
    if not _ARCHITECTURES:
        _populate_default_registry()
    try:
        return _ARCHITECTURES[name]
    except KeyError:
        raise KeyError(
            f"unknown architecture {name!r}; known: "
            f"{sorted(_ARCHITECTURES)}") from None


def list_architectures():
    if not _ARCHITECTURES:
        _populate_default_registry()
    return sorted(_ARCHITECTURES)


def _populate_default_registry():
    from graph_neural_networks_torch.models import architectures as a
    from graph_neural_networks_torch.models import architectures_time as at
    for mod in (a, at):
        for nm in getattr(mod, "__all__", []):
            obj = getattr(mod, nm, None)
            if isinstance(obj, type):
                _ARCHITECTURES.setdefault(nm, obj)


# ---------------------------------------------------------------------------
# Typed config dataclasses
# ---------------------------------------------------------------------------

class _ConfigBase:
    """from_dict/to_dict/JSON round-trip with unknown-key + type checks."""

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "_ConfigBase":
        names = {f.name: f for f in dataclasses.fields(cls)}
        unknown = set(d) - set(names)
        if unknown:
            raise ValueError(
                f"{cls.__name__}: unknown config keys {sorted(unknown)}; "
                f"valid: {sorted(names)}")
        kwargs = {}
        for k, v in d.items():
            f = names[k]
            sub = _nested_config_type(f.type)
            if sub is not None and isinstance(v, dict):
                v = sub.from_dict(v)
            kwargs[k] = v
        obj = cls(**kwargs)
        obj.validate()
        return obj

    def to_dict(self) -> Dict[str, Any]:
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out[f.name] = v.to_dict() if isinstance(v, _ConfigBase) else v
        return out

    def save(self, path: str):
        with open(path, "w") as fh:
            json.dump(self.to_dict(), fh, indent=1, default=_json_default)

    @classmethod
    def load(cls, path: str):
        with open(path) as fh:
            return cls.from_dict(json.load(fh))

    def validate(self):
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            expect = _scalar_type(f.type)
            if expect is not None and v is not None \
                    and not isinstance(v, expect):
                # int where float is declared is fine
                if expect is float and isinstance(v, int):
                    setattr(self, f.name, float(v))
                    continue
                raise TypeError(
                    f"{type(self).__name__}.{f.name}: expected "
                    f"{expect.__name__}, got {type(v).__name__} ({v!r})")


_TYPE_NAMES = {"int": int, "float": float, "str": str, "bool": bool,
               "dict": dict, "list": list}


def _scalar_type(t):
    if isinstance(t, str):
        t = t.split("[")[0].replace("Optional", "").strip("[]")
        return _TYPE_NAMES.get(t)
    return t if t in (int, float, str, bool) else None


def _nested_config_type(t):
    if isinstance(t, str):
        g = globals().get(t)
        return g if isinstance(g, type) and issubclass(g, _ConfigBase) \
            else None
    return t if isinstance(t, type) and issubclass(t, _ConfigBase) else None


def _json_default(o):
    import numpy as np
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON-serializable: {type(o)}")


@dataclass
class ModelConfig(_ConfigBase):
    """One model: registered architecture name + its ctor kwargs (the
    reference's model dicts, sourceLocGNN.py:234-268, made explicit)."""
    architecture: str = "SelectionGNN"
    kwargs: dict = field(default_factory=dict)

    def build(self, GSO, **extra):
        """The architecture on GSO; `extra` adds constructor keywords (the
        port's ``device=`` and ``generator=``)."""
        cls = get_architecture(self.architecture)
        return cls(**{**self.kwargs, **extra, "GSO": GSO})


@dataclass
class TrainingConfig(_ConfigBase):
    nEpochs: int = 40
    batchSize: int = 100
    lr: float = 1e-3
    optimizer: str = "ADAM"
    beta1: float = 0.9
    beta2: float = 0.999
    validationInterval: int = 20
    earlyStoppingLag: int = 0
    learningRateDecayRate: Optional[float] = None
    learningRateDecayPeriod: Optional[int] = None

    def optimizer_spec(self) -> dict:
        """The spec dict of ``training.make_optimizer``, as JAX's."""
        return {"name": self.optimizer, "lr": self.lr,
                "betas": (self.beta1, self.beta2)}


@dataclass
class GraphConfig(_ConfigBase):
    graphType: str = "SBM"
    nNodes: int = 100
    options: dict = field(default_factory=dict)


@dataclass
class ExperimentConfig(_ConfigBase):
    name: str = "experiment"
    seed: int = 0
    saveDir: str = "experiments"
    graph: GraphConfig = field(default_factory=GraphConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    data: dict = field(default_factory=dict)
