"""The JAX package's graph fuzz suites on the port (webaudio_tpu_torch),
on the CPU, through tests/torch_switch.py: tests/test_graph_fuzz_oracle.py
(random acyclic graphs against a full-signal numpy oracle),
test_graph_fuzz_multichannel.py (channel counting and mixing against the
spec's matrices), test_graph_fuzz_drivers.py (RenderSession with a
save/restore, and the online loop mounted at an offset, against the same
oracle) and test_graph_fuzz_batch.py (mixed batches against each
context's own render; 8 time segments on 8 CPU devices against the
sequential render).  Each reuses its file's builder and oracle at the
file's own bound (5e-5 x peak); every test is collected here as
`test_<suite>__<name>`.

The random graphs also render through both packages: the port within
1e-6 x peak of the JAX package (a re-anchor's probe measured 1.6e-7 on
the oracle graphs and 9.2e-8 of the spec oracle on the multichannel
ones).
"""

import numpy as np
import pytest

import test_graph_fuzz_multichannel as jmulti
import test_graph_fuzz_oracle as joracle
from torch_switch import HERE, collect, load_on_port

FUZZ = [HERE / f"test_graph_fuzz_{name}.py"
        for name in ("oracle", "multichannel", "drivers", "batch")]

globals().update(collect(FUZZ, set(), "test_graph_fuzz"))


def _rendered(ctx):
    return np.asarray(ctx.start_rendering_sync().to_array())


@pytest.mark.parametrize("suite,seed", [(s, n) for s in ("oracle",
                                                         "multichannel")
                                        for n in range(10)])
def test_random_graphs_match_jax(suite, seed):
    jax_suite = {"oracle": joracle, "multichannel": jmulti}[suite]
    port_suite = load_on_port(HERE / f"test_graph_fuzz_{suite}.py")
    want = _rendered(jax_suite._build_random_pair(seed)[0])
    got = _rendered(port_suite._build_random_pair(seed)[0])
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-3)
    assert float(np.abs(got - want).max()) <= 1e-6 * scale
