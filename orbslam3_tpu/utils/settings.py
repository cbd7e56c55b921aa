"""Typed settings loaded from the reference's YAML files.

Role-parity with /root/reference/include/Settings.h:58 + src/Settings.cc
(620 LoC): reads the cv::FileStorage YAML the reference ships (EuRoC.yaml,
KITTI*.yaml, TUM-VI.yaml ...) — camera model + intrinsics (+ second camera
and Tlr for stereo), resolution/resize, stereo baseline (Camera.bf),
depth threshold, IMU noise/frequency/Tbc, ORB extractor parameters, viewer
parameters, atlas load/save paths.  Legacy flat-key files (pre-`File.version
1.0`, parsed by Tracking::ParseCamParamFile in the reference, Tracking1.cc:619)
are auto-detected and mapped onto the same fields.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def _scalar(text: str):
    """One cv::FileStorage YAML scalar: int, float, quoted or bare string,
    or an inline [a, b, ...] sequence."""
    text = text.strip()
    if text.startswith("[") and text.endswith("]"):
        body = text[1:-1].strip()
        return [_scalar(t) for t in body.split(",")] if body else []
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "\"'":
        return text[1:-1]
    if text in ("", "~", "null"):
        return None
    low = text.lower()
    if low in ("true", "false"):
        return low == "true"
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#":
            return line[:i]
    return line


def _parse_cv_yaml(path: str) -> dict:
    """cv::FileStorage YAML -> dict, without PyYAML.

    Covers the subset the reference's settings files use: the %YAML
    directive and document markers, top-level `key: scalar` lines, and
    `key: !!opencv-matrix` maps whose indented fields (rows, cols, dt,
    data) may continue an inline `[...]` list over several lines."""
    with open(path) as f:
        lines = [_strip_comment(l).rstrip() for l in f]
    data: dict = {}
    block = None  # the indented map being filled, if any
    pending = None  # (map, key, text) of a `[...]` list still open
    for line in lines:
        if pending is not None:
            pending[2].append(line.strip())
            if line.strip().endswith("]"):
                target, key, parts = pending
                target[key] = _scalar(" ".join(parts))
                pending = None
            continue
        if not line.strip() or line.startswith("%") or line.startswith("---"):
            continue
        indented = line[0] in " \t"
        key, sep, value = line.strip().partition(":")
        if not sep:
            raise ValueError(f"{path}: cannot parse line {line!r}")
        key, value = key.strip(), value.strip()
        if indented:
            if block is None:
                raise ValueError(f"{path}: indented line outside a map: {line!r}")
            target = block
        else:
            target, block = data, None
        if value.startswith("!!"):
            value = value.split(None, 1)[1] if " " in value else ""
        if value == "" and not indented:
            block = data[key] = {}
        elif value.startswith("[") and not value.endswith("]"):
            pending = (target, key, [value])
        else:
            target[key] = _scalar(value)
    if pending is not None:
        raise ValueError(f"{path}: unterminated list for {pending[1]!r}")
    return data


def _as_matrix(node) -> np.ndarray:
    if isinstance(node, dict) and "data" in node:
        return np.asarray(node["data"], np.float64).reshape(
            int(node["rows"]), int(node["cols"])
        )
    return np.asarray(node, np.float64)


@dataclass
class Settings:
    sensor: str = "stereo"
    camera_type: str = "PinHole"          # PinHole | KannalaBrandt8 | Rectified
    camera1: np.ndarray = field(default_factory=lambda: np.zeros(4))
    dist1: np.ndarray | None = None
    camera2: np.ndarray | None = None
    dist2: np.ndarray | None = None
    lapping1: tuple | None = None
    lapping2: tuple | None = None
    Tlr: np.ndarray | None = None         # 3x4 or 4x4 stereo extrinsics
    width: int = 752
    height: int = 480
    new_width: int = -1
    new_height: int = -1
    fps: float = 30.0
    rgb: bool = True
    bf: float = 0.0                        # stereo baseline * fx
    depth_th_factor: float = 35.0          # ThDepth
    depth_map_factor: float = 1.0          # RGBD.DepthMapFactor (units per meter)
    # IMU
    imu_freq: float = 0.0
    imu_noise_gyro: float = 0.0
    imu_noise_acc: float = 0.0
    imu_walk_gyro: float = 0.0
    imu_walk_acc: float = 0.0
    Tbc: np.ndarray | None = None
    # ORB
    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7
    # viewer
    viewer: dict = field(default_factory=dict)
    # deviation knobs (tuning gates for this framework's deliberate
    # semantic deviations from the reference; absent keys keep defaults)
    tuning: dict = field(default_factory=dict)
    # atlas persistence
    load_atlas: str | None = None
    save_atlas: str | None = None

    def make_camera(self, which: int = 1):
        from orbslam3_tpu.cameras.models import KannalaBrandt8, Pinhole

        params = self.camera1 if which == 1 else self.camera2
        dist = self.dist1 if which == 1 else self.dist2
        if self.camera_type in ("PinHole", "Rectified"):
            return Pinhole(params[:4], dist)
        return KannalaBrandt8(params[:8])

    # --- rectification / resize (Settings.h:157 precomputeRectificationMaps,
    # Settings.cc:346-375 resize scaling) ---------------------------------
    @property
    def needs_rectify(self) -> bool:
        """Unrectified pinhole stereo: the row-constrained matcher needs
        rectified input, so maps must be precomputed (reference sets
        bNeedToRectify_ for PinHole stereo at Settings.cc:199,274)."""
        return (
            "stereo" in self.sensor
            and self.camera_type == "PinHole"
            and self.camera2 is not None
            and self.Tlr is not None
        )

    @property
    def needs_resize(self) -> bool:
        return (
            self.new_width > 0
            and self.new_height > 0
            and (self.new_width != self.width or self.new_height != self.height)
        )

    @property
    def new_size(self) -> tuple[int, int]:
        if self.needs_resize:
            return (self.new_width, self.new_height)
        return (self.width, self.height)

    def make_rectifier(self):
        """Precompute the stereo rectification state; folds the optional
        newWidth/newHeight resize into the maps (reference builds them at
        newImSize_, Settings.cc:484-491)."""
        from orbslam3_tpu.frontend.rectify import StereoRectifier
        from orbslam3_tpu.utils.lie import SE3

        mat = np.asarray(self.Tlr, np.float64)
        if mat.shape == (3, 4):
            mat = np.vstack([mat, [0.0, 0.0, 0.0, 1.0]])
        tlr = SE3.from_matrix(mat)
        return StereoRectifier(
            self.make_camera(1),
            self.make_camera(2),
            tlr,
            (self.width, self.height),
            new_size=self.new_size if self.needs_resize else None,
        )

    def scaled_camera_params(self):
        """Calibration scaled for the newWidth/newHeight resize in the
        NON-rectified path (Settings.cc:352-374 scaleRow/ColFactor)."""
        p = np.array(self.camera1, np.float64)
        sx = self.new_width / self.width
        sy = self.new_height / self.height
        p[0] *= sx  # fx
        p[2] *= sx  # cx
        p[1] *= sy  # fy
        p[3] *= sy  # cy
        return p

    def make_orb_params(self):
        from orbslam3_tpu.oracle.orb_cpu import PyramidParams

        return PyramidParams(
            n_features=self.n_features,
            scale_factor=self.scale_factor,
            n_levels=self.n_levels,
            ini_th_fast=self.ini_th_fast,
            min_th_fast=self.min_th_fast,
        )


def load_settings(path: str, sensor: str = "stereo") -> Settings:
    d = _parse_cv_yaml(path)
    s = Settings(sensor=sensor)

    def get(*keys, default=None):
        for k in keys:
            if k in d and d[k] is not None:
                return d[k]
        return default

    s.camera_type = str(get("Camera.type", "File.type", default="PinHole"))
    # modern keys (Camera1.fx) or legacy (Camera.fx)
    def cam_params(prefix):
        fx = get(f"{prefix}.fx")
        if fx is None:
            return None, None
        base = [
            float(get(f"{prefix}.fx")), float(get(f"{prefix}.fy")),
            float(get(f"{prefix}.cx")), float(get(f"{prefix}.cy")),
        ]
        if s.camera_type == "KannalaBrandt8":
            base += [float(get(f"{prefix}.k{i}", default=0.0)) for i in (1, 2, 3, 4)]
            return np.asarray(base), None
        dist = [float(get(f"{prefix}.k1", default=0.0)),
                float(get(f"{prefix}.k2", default=0.0)),
                float(get(f"{prefix}.p1", default=0.0)),
                float(get(f"{prefix}.p2", default=0.0))]
        k3 = get(f"{prefix}.k3")
        if k3 is not None:
            dist.append(float(k3))
        dist = np.asarray(dist)
        return np.asarray(base), (dist if np.any(dist) else None)

    p1, d1 = cam_params("Camera1")
    if p1 is None:
        p1, d1 = cam_params("Camera")
    s.camera1, s.dist1 = p1, d1
    p2, d2 = cam_params("Camera2")
    s.camera2, s.dist2 = p2, d2
    lap = get("Camera1.overlappingBegin")
    if lap is not None:
        s.lapping1 = (float(lap), float(get("Camera1.overlappingEnd", default=0)))
        s.lapping2 = (
            float(get("Camera2.overlappingBegin", default=0)),
            float(get("Camera2.overlappingEnd", default=0)),
        )
    tlr = get("Stereo.T_c1_c2", "Tlr")
    if tlr is not None:
        s.Tlr = _as_matrix(tlr)
    s.width = int(get("Camera.width", default=752))
    s.height = int(get("Camera.height", default=480))
    s.new_width = int(get("Camera.newWidth", default=-1))
    s.new_height = int(get("Camera.newHeight", default=-1))
    s.fps = float(get("Camera.fps", default=30))
    s.rgb = bool(get("Camera.RGB", default=1))
    bf = get("Stereo.b", default=None)
    if bf is not None and s.camera1 is not None:
        s.bf = float(bf) * float(s.camera1[0])
    else:
        s.bf = float(get("Camera.bf", default=0.0))
    s.depth_th_factor = float(get("Stereo.ThDepth", "ThDepth", default=35.0))
    dmf = float(get("RGBD.DepthMapFactor", "DepthMapFactor", default=1.0))
    s.depth_map_factor = dmf if abs(dmf) > 1e-5 else 1.0

    s.imu_freq = float(get("IMU.Frequency", default=0.0))
    sf = np.sqrt(s.imu_freq) if s.imu_freq > 0 else 1.0
    s.imu_noise_gyro = float(get("IMU.NoiseGyro", default=0.0)) * sf
    s.imu_noise_acc = float(get("IMU.NoiseAcc", default=0.0)) * sf
    s.imu_walk_gyro = float(get("IMU.GyroWalk", default=0.0)) / max(sf, 1e-9)
    s.imu_walk_acc = float(get("IMU.AccWalk", default=0.0)) / max(sf, 1e-9)
    tbc = get("IMU.T_b_c1", "Tbc")
    if tbc is not None:
        s.Tbc = _as_matrix(tbc)

    s.n_features = int(get("ORBextractor.nFeatures", default=1000))
    s.scale_factor = float(get("ORBextractor.scaleFactor", default=1.2))
    s.n_levels = int(get("ORBextractor.nLevels", default=8))
    s.ini_th_fast = int(get("ORBextractor.iniThFAST", default=20))
    s.min_th_fast = int(get("ORBextractor.minThFAST", default=7))

    s.viewer = {k: v for k, v in d.items() if k.startswith("Viewer.")}
    s.tuning = {
        k.split(".", 1)[1]: v for k, v in d.items() if k.startswith("Tuning.")
    }
    s.load_atlas = get("System.LoadAtlasFromFile")
    s.save_atlas = get("System.SaveAtlasToFile")
    return s
