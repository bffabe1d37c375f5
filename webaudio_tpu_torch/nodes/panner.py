"""PannerNode + AudioListener: 3D spatialization (equal-power model).

reference: src/node/panner.rs + src/spatial.rs.  The per-sample zip over 15
spatial params (panner.rs:729-779) becomes one tensor pipeline over the
block: azimuth and elevation in the listener's frame (spatial.rs:205-270),
the linear, inverse and exponential distance models (panner.rs:955-985),
the cone gain (panner.rs:927-953) and the equal-power ear gains for mono
and stereo input (panner.rs:988-1055), all as `where` selects.  Ported
from `webaudio_tpu/nodes/panner.py`: every comparison and clamp runs in
f32 in the JAX package's order.

The AudioListener is a registered hidden node holding 9 a-rate params
(reference: spatial.rs:34-45); panners read them through the compiler's
foreign params (`AudioNode.foreign_params`).  The HRTF panning model is in
nodes/hrtf.py.  A kernel copies the node's distance, cone and panning
settings as plain Python values, so `parallel/batch.py::graph_fingerprint`
sees them.
"""

from __future__ import annotations

from enum import Enum

import numpy as np
import torch

from ..constants import InvalidStateError, NotSupportedError
from ..graph.compiler import Kernel
from ..ops.mixing import ChannelCountMode
from ..param import AudioParamDescriptor, AutomationRate
from .audio_node import AudioNode, AudioNodeOptions, ChannelConfig


class PanningModelType(str, Enum):
    EQUAL_POWER = "equalpower"
    HRTF = "HRTF"


class DistanceModelType(str, Enum):
    LINEAR = "linear"
    INVERSE = "inverse"
    EXPONENTIAL = "exponential"


_FMAX = 3.4028235e38
_F32_MIN_NORMAL = 1.17549435e-38
HALF_PI = float(np.float32(np.pi / 2.0))


def _param(node, name, default):
    return node._register_param(name, AudioParamDescriptor(
        name=name, automation_rate=AutomationRate.A, default_value=default,
        min_value=-_FMAX, max_value=_FMAX))


class _SilentKernel(Kernel):
    def tail_frames(self):
        return 0

    def process(self, scope, state, inputs, params):
        return state, [torch.zeros((1, 1, scope.frames), dtype=torch.float32,
                                   device=scope.device)]


class AudioListener(AudioNode):
    """Hidden node owning the 9 listener params
    (reference: spatial.rs:34-45)."""

    _number_of_inputs = 0
    _number_of_outputs = 1

    def __init__(self, context):
        super().__init__(context)
        for name, default in (("position_x", 0.0), ("position_y", 0.0),
                              ("position_z", 0.0), ("forward_x", 0.0),
                              ("forward_y", 0.0), ("forward_z", -1.0),
                              ("up_x", 0.0), ("up_y", 1.0), ("up_z", 0.0)):
            setattr(self, name, _param(self, name, default))

    def output_channel_count(self, input_counts):
        return [1]

    def make_kernel(self, render_ctx):
        return _SilentKernel()


# --- the spatial math (spatial.rs) ------------------------------------------
# Each vector is a list of 3 f32 tensors of shape () or (N, 1, T).

def _normalize(v):
    n2 = v[0] ** 2 + v[1] ** 2 + v[2] ** 2
    inv = torch.where(n2 > 0.0, 1.0 / torch.sqrt(torch.clamp(n2, min=1e-38)),
                      0.0)
    return [v[0] * inv, v[1] * inv, v[2] * inv], n2


def _cross(a, b):
    return [a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]]


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def azimuth_elevation(sp, lp, lf, lu):
    """spatial.rs:205-270: (azimuth, elevation) in degrees of the source at
    sp seen by a listener at lp facing lf with up lu."""
    rel = [sp[i] - lp[i] for i in range(3)]
    rel_len2 = rel[0] ** 2 + rel[1] ** 2 + rel[2] ** 2
    degenerate = rel_len2 <= _F32_MIN_NORMAL

    sl, _ = _normalize(rel)
    lright_norm, lright_len2 = _normalize(_cross(lf, lu))
    no_right = lright_len2 == 0.0
    lforward_norm, _ = _normalize(lf)
    up = _cross(lright_norm, lforward_norm)

    dot_up = torch.clamp(_dot(sl, up), -1.0, 1.0)
    elevation = 90.0 - 180.0 * torch.arccos(dot_up) / np.pi
    elevation = torch.where(elevation > 90.0, 180.0 - elevation, elevation)
    elevation = torch.where(elevation < -90.0, -180.0 - elevation, elevation)

    proj = [sl[i] - up[i] * dot_up for i in range(3)]
    proj_norm, proj_len2 = _normalize(proj)
    proj_zero = proj_len2 == 0.0

    dot_right = torch.clamp(_dot(proj_norm, lright_norm), -1.0, 1.0)
    azimuth = 180.0 * torch.arccos(dot_right) / np.pi
    front_back = _dot(proj_norm, lforward_norm)
    azimuth = torch.where(front_back < 0.0, 360.0 - azimuth, azimuth)
    azimuth = torch.where((azimuth >= 0.0) & (azimuth <= 270.0),
                          90.0 - azimuth, 450.0 - azimuth)

    azimuth = torch.where(degenerate | no_right | proj_zero, 0.0, azimuth)
    elevation = torch.where(degenerate | no_right, 0.0, elevation)
    return azimuth, elevation


def source_listener_angle(sp, so, lp):
    """spatial.rs:278-300: the angle in degrees between the source's
    orientation and the listener seen from the source."""
    so_norm, so_len2 = _normalize(so)
    rel = [sp[i] - lp[i] for i in range(3)]
    rel_len2 = rel[0] ** 2 + rel[1] ** 2 + rel[2] ** 2
    sl, _ = _normalize(rel)
    d = torch.clamp(_dot(sl, so_norm), -1.0, 1.0)
    ang = torch.abs(180.0 * torch.arccos(d) / np.pi)
    return torch.where((so_len2 == 0.0) | (rel_len2 <= _F32_MIN_NORMAL),
                       0.0, ang)


class _SpatialKernel(Kernel):
    """The node's distance and cone settings, copied as plain values."""

    def __init__(self, node: "PannerNode"):
        self.distance_model = node.distance_model.value
        self.ref_distance = node.ref_distance
        self.max_distance = node.max_distance
        self.rolloff_factor = node.rolloff_factor
        self.cone_inner_angle = node.cone_inner_angle
        self.cone_outer_angle = node.cone_outer_angle
        self.cone_outer_gain = node.cone_outer_gain

    def spatial_gains(self, params):
        """(azimuth, elevation, distance gain x cone gain) from the own and
        the listener's (`l_*`) params (reference: panner.rs:927-985 and
        spatial.rs)."""
        sp = [params["position_x"], params["position_y"], params["position_z"]]
        so = [params["orientation_x"], params["orientation_y"],
              params["orientation_z"]]
        lp = [params["l_position_x"], params["l_position_y"],
              params["l_position_z"]]
        lf = [params["l_forward_x"], params["l_forward_y"],
              params["l_forward_z"]]
        lu = [params["l_up_x"], params["l_up_y"], params["l_up_z"]]

        azimuth, elevation = azimuth_elevation(sp, lp, lf, lu)

        # distance gain (panner.rs:955-985): f64 in the reference, f32 here
        dist = torch.sqrt((sp[0] - lp[0]) ** 2 + (sp[1] - lp[1]) ** 2
                          + (sp[2] - lp[2]) ** 2)
        ref_d = self.ref_distance
        if self.distance_model == DistanceModelType.LINEAR.value:
            rolloff = min(max(self.rolloff_factor, 0.0), 1.0)
            d2ref = min(ref_d, self.max_distance)
            d2max = max(ref_d, self.max_distance)
            dcl = torch.clamp(dist, d2ref, d2max)
            gain = 1.0 - rolloff * (dcl - d2ref) / (d2max - d2ref)
        elif self.distance_model == DistanceModelType.INVERSE.value:
            rolloff = max(self.rolloff_factor, 0.0)
            gain = torch.where(
                dist > 0.0,
                ref_d / (ref_d + rolloff * (torch.clamp(dist, min=ref_d)
                                            - ref_d)),
                1.0)
        else:
            rolloff = max(self.rolloff_factor, 0.0)
            gain = (torch.clamp(dist, min=ref_d) / ref_d) ** (-rolloff)

        # cone gain (panner.rs:927-953)
        abs_inner = abs(self.cone_inner_angle) / 2.0
        abs_outer = abs(self.cone_outer_angle) / 2.0
        if abs_inner >= 180.0 and abs_outer >= 180.0:
            return azimuth, elevation, gain
        ang = source_listener_angle(sp, so, lp)
        span = max(abs_outer - abs_inner, 1e-20)
        t = (ang - abs_inner) / span
        mid = (1.0 - t) + self.cone_outer_gain * t
        cone = torch.where(ang < abs_inner, 1.0,
                           torch.where(ang >= abs_outer,
                                       self.cone_outer_gain, mid))
        return azimuth, elevation, gain * cone


class _EqualPowerPannerKernel(_SpatialKernel):
    def __init__(self, node: "PannerNode", mono_input: bool):
        super().__init__(node)
        self.mono_input = mono_input

    def tail_frames(self):
        return 0

    def process(self, scope, state, inputs, params):
        x = inputs[0]                                   # (N, C, B)
        azimuth, _elevation, g = self.spatial_gains(params)

        # ear gains (panner.rs:988-1055)
        az = torch.clamp(azimuth, -180.0, 180.0)
        az = torch.where(az < -90.0, -180.0 - az,
                         torch.where(az > 90.0, 180.0 - az, az))
        if self.mono_input:
            xx = (az + 90.0) / 180.0
            gl = torch.cos(xx * HALF_PI)
            gr = torch.sin(xx * HALF_PI)
            mono = x[:, 0:1]
            out = torch.cat(torch.broadcast_tensors(mono * gl * g,
                                                    mono * gr * g), 1)
        else:
            left_side = az <= 0.0
            xx = torch.where(left_side, (az + 90.0) / 90.0, az / 90.0)
            gl = torch.cos(xx * HALF_PI)
            gr = torch.sin(xx * HALF_PI)
            il, ir = x[:, 0:1], x[:, 1:2]
            left = torch.where(left_side, il + ir * gl, il * gl)
            right = torch.where(left_side, ir * gr, ir + il * gr)
            out = torch.cat(torch.broadcast_tensors(left * g, right * g), 1)
        return state, [out.to(torch.float32)]


class PannerNode(AudioNode):
    _number_of_inputs = 1
    _number_of_outputs = 1

    def __init__(self, context, panning_model: str = "equalpower",
                 distance_model: str = "inverse",
                 position_x: float = 0.0, position_y: float = 0.0,
                 position_z: float = 0.0, orientation_x: float = 1.0,
                 orientation_y: float = 0.0, orientation_z: float = 0.0,
                 ref_distance: float = 1.0, max_distance: float = 10000.0,
                 rolloff_factor: float = 1.0, cone_inner_angle: float = 360.0,
                 cone_outer_angle: float = 360.0, cone_outer_gain: float = 0.0,
                 **options):
        cfg = ChannelConfig(count=2, mode=ChannelCountMode.CLAMPED_MAX)
        super().__init__(context,
                         options=AudioNodeOptions(**options) if options else None,
                         channel_config=cfg)
        for name, default, value in (
                ("position_x", 0.0, position_x),
                ("position_y", 0.0, position_y),
                ("position_z", 0.0, position_z),
                ("orientation_x", 1.0, orientation_x),
                ("orientation_y", 0.0, orientation_y),
                ("orientation_z", 0.0, orientation_z)):
            p = _param(self, name, default)
            setattr(self, name, p)
            if value != default:
                p.set_value(value)

        self._panning_model = PanningModelType(panning_model)
        self.distance_model = DistanceModelType(distance_model)
        if ref_distance < 0:
            raise RuntimeError("RangeError - refDistance must be non-negative")
        if max_distance <= 0:
            raise RuntimeError("RangeError - maxDistance must be positive")
        if rolloff_factor < 0:
            raise RuntimeError("RangeError - rolloffFactor must be non-negative")
        if not (0.0 <= cone_outer_gain <= 1.0):
            raise InvalidStateError("coneOuterGain must be in [0, 1]")
        self.ref_distance = float(ref_distance)
        self.max_distance = float(max_distance)
        self.rolloff_factor = float(rolloff_factor)
        self.cone_inner_angle = float(cone_inner_angle)
        self.cone_outer_angle = float(cone_outer_angle)
        self.cone_outer_gain = float(cone_outer_gain)
        # the listener (and its params) exists once a panner does
        context.listener

    @property
    def panning_model(self) -> PanningModelType:
        return self._panning_model

    @panning_model.setter
    def panning_model(self, v):
        self._panning_model = PanningModelType(v)
        self.context._invalidate_graph_cache()

    def set_position(self, x: float, y: float, z: float):
        self.position_x.set_value(x)
        self.position_y.set_value(y)
        self.position_z.set_value(z)

    def set_orientation(self, x: float, y: float, z: float):
        self.orientation_x.set_value(x)
        self.orientation_y.set_value(y)
        self.orientation_z.set_value(z)

    def _validate_channel_count(self, count: int):
        if count > 2:
            raise NotSupportedError(
                "PannerNode channel count cannot be greater than two")

    def _validate_channel_count_mode(self, mode: ChannelCountMode):
        if mode == ChannelCountMode.MAX:
            raise NotSupportedError(
                "PannerNode channel count mode cannot be set to max")

    def foreign_params(self):
        l = self.context.listener
        return {f"l_{name}": (l, name) for name in (
            "position_x", "position_y", "position_z", "forward_x",
            "forward_y", "forward_z", "up_x", "up_y", "up_z")}

    def output_channel_count(self, input_counts):
        return [2]

    def make_kernel(self, render_ctx):
        if self._panning_model == PanningModelType.HRTF:
            from .hrtf import HrtfPannerKernel

            return HrtfPannerKernel(self, render_ctx)
        return _EqualPowerPannerKernel(
            self, mono_input=render_ctx.input_channel_counts[0] == 1)
