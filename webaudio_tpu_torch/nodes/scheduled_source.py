"""AudioScheduledSourceNode: start/stop scheduling.

reference: src/node/scheduled_source.rs:6-57.  Times become host-side f64
frame bounds at compile time (exact: `n/fs >= t  <=>  n >= ceil(t*fs)`);
the `ended` event is computed from the schedule after rendering.  Ported
from `webaudio_tpu/nodes/scheduled_source.py`; it holds no tensor code.
"""

from __future__ import annotations

import math

from ..constants import InvalidStateError, assert_valid_time_value
from .audio_node import AudioNode


class AudioScheduledSourceNode(AudioNode):
    _number_of_inputs = 0
    _number_of_outputs = 1

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._start_time = math.inf
        self._stop_time = math.inf
        self._start_called = False
        self._stop_called = False
        self._onended = None

    def start(self, when: float = 0.0):
        if self._start_called:
            raise InvalidStateError("Cannot call `start` twice")
        assert_valid_time_value(when)
        self._start_called = True
        # [spec] values below currentTime start immediately
        # (reference: oscillator.rs:419-424 "prevent scheduling in the past")
        self._start_time = max(float(when), self.context.current_time)
        self.context._invalidate_graph_cache()

    def start_at(self, when: float):
        self.start(when)

    def stop(self, when: float = 0.0):
        if not self._start_called:
            raise InvalidStateError(
                "Cannot call `stop` without calling `start` first")
        assert_valid_time_value(when)
        # repeated stop() is allowed and reschedules (reference:
        # scheduled_source.rs run_stop_twice, upstream issue #579)
        self._stop_called = True
        self._stop_time = float(when)
        self.context._invalidate_graph_cache()

    def stop_at(self, when: float):
        self.stop(when)

    def set_onended(self, callback):
        self._onended = callback

    def _schedule_frames(self, sample_rate: float) -> tuple[int, int]:
        """(first active frame, first inactive frame), host-side exact."""
        inf = 2**31 - 1
        start = inf if math.isinf(self._start_time) else \
            _time_to_frame(self._start_time, sample_rate)
        stop = inf if math.isinf(self._stop_time) else \
            _time_to_frame(self._stop_time, sample_rate)
        return start, stop


def _time_to_frame(t: float, sample_rate: float) -> int:
    """ceil(t*fs) with the reference's sticky sample-grid snap
    (audio_buffer_source.rs:651-653): a time within relative fp-epsilon of
    an exact sample boundary counts as on the boundary, so `k/fs`-style
    schedules never leak into the next frame (WPT sub-sample-scheduling)."""
    f = t * sample_rate
    r = round(f)
    if abs(f - r) <= 1.5e-8 * max(abs(f), 1.0):
        f = r
    return int(math.ceil(f))
