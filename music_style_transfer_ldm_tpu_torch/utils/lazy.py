"""Package names that load their module on first use (PEP 562), for a
re-export that would pull a heavy module, or one that imports the
package back, into the package's import."""

from __future__ import annotations

import importlib


def lazy_exports(package: str, exports: dict):
    """(``__getattr__``, ``__dir__``) for ``package``: each name of
    ``exports`` ({name: submodule}) is ``package.submodule.name``, or the
    submodule itself where name == submodule."""
    def __getattr__(name):
        if name not in exports:
            raise AttributeError(f"module {package!r} has no attribute "
                                 f"{name!r}")
        module = importlib.import_module(f"{package}.{exports[name]}")
        return module if name == exports[name] else getattr(module, name)

    def __dir__():
        return sorted(set(vars(importlib.import_module(package)))
                      | set(exports))

    return __getattr__, __dir__
