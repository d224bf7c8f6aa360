"""Model registry: names to factory callables returning `nn.Module`s
(the role timm's registry plays in the reference)."""

from __future__ import annotations

_REGISTRY = {}


def register_model(fn=None, *, name: str = None):
    def wrap(f):
        _REGISTRY[name or f.__name__] = f
        return f

    if fn is not None:
        return wrap(fn)
    return wrap


def create_model(name: str, **kwargs):
    from dig_tpu_torch.models import moco, vit  # noqa: F401  (registers the models)

    if name not in _REGISTRY:
        raise KeyError(f"unknown model '{name}'; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)

