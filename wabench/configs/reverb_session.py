"""BASELINE config 3 as a long-form job: the graph of `reverb.py`, its
settings and its plain reference, rendered for hours by a `RenderSession`
that checkpoints as it goes.  The graph, the hooks and the reference are
the reverb's own; what differs is the deployment `reverb_session.json`
states: the render's length, the checkpoint cadence, and the guarantee
that a resumed render equals the uninterrupted one.
"""

from __future__ import annotations

from wabench.configs.reverb import (build, inputs, prepare,  # noqa: F401
                                    reference, settings, stage)
