"""Load a script of the repository outside ``src`` (an example or a
tool) as a module, without running its ``__main__`` block (not
collected)."""
from __future__ import annotations

import importlib.util
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(path: str, name: str):
    """The module at ``path`` (relative to the repository)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
