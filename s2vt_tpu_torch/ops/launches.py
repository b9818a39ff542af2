"""The launch counters of the kernel wrappers.

Each wrapper of ``ops/`` that launches a kernel of ``csrc/`` counts its
launches in ``.launches`` and, by route, in ``.route_launches``; ``counted``
gives a wrapper both and registers it in ``COUNTED`` (keyed by module and
name, so a reloaded module replaces its entries). Code that reads or adjusts
every counter at once (``training/step_graph.py``) reads ``COUNTED``: a
wrapper counts there once its module is imported, which every launch of it
implies.
"""

from __future__ import annotations

from typing import Callable, Dict

COUNTED: Dict[str, Callable] = {}


def counted(fn: Callable, *routes: str) -> Callable:
    """Give ``fn`` zeroed ``.launches`` and ``.route_launches`` (one entry
    per route) and register it in ``COUNTED``."""
    fn.launches = 0
    fn.route_launches = dict.fromkeys(routes, 0)
    COUNTED[f"{fn.__module__}.{fn.__qualname__}"] = fn
    return fn
