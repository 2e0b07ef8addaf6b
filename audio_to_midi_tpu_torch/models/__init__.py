"""The model: the ConvNeXt CNN, the transformer, RoPE and the decoder.

Exports the names of the JAX package's ``models/__init__.py`` that the port
has.  They load at their first use: the kernel modules under ``ops/``
import ``models.rope`` and ``models.nn``, and an eager import of
``models.attention`` here would close a cycle through them.
"""

import importlib

_SUBMODULES = ("attention", "convnext", "model", "nn", "rope", "transformer")
_NAMES = {
    "cast_params": "model",
    "forward": "model",
    "init": "model",
    "make_rope": "model",
    "param_count": "model",
    "predict": "model",
    "RopeFreqs": "rope",
    "apply_rope": "rope",
    "precompute_frequencies": "rope",
}

__all__ = [*_SUBMODULES, *_NAMES]


def __getattr__(name: str):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    if name in _NAMES:
        return getattr(importlib.import_module(f"{__name__}.{_NAMES[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
