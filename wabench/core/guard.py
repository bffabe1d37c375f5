"""The modules a run of the port must never load: JAX and the JAX
package.  Compared by whole top-level name, so `webaudio_tpu_torch`
passes where `webaudio_tpu` does not."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "webaudio_tpu"})


def forbidden_loaded(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)
