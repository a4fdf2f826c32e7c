"""Global constants and string keys (a copy of thr3ed_atom_tpu/utils/constants.py).

Parity: reference thre3d_atom/utils/constants.py:1-27, thre3d_atom/thre3d_reprs/constants.py:1-11,
thre3d_atom/data/constants.py:1-9 and thre3d_atom/visualizations/constants.py:1-6.
"""

# dimensionality constants
NUM_COORD_DIMENSIONS = 3
NUM_COLOUR_CHANNELS = 3
NUM_RGBA_CHANNELS = 4

# random seed used across the framework
SEED = 42

# numerical guards
ZERO_PLUS = 1e-10
INFINITY = 1e10

# keys used by RenderOut.extra
EXTRA_ACCUMULATED_WEIGHTS = "accumulated_weight"
EXTRA_DISPARITY = "disparity"
EXTRA_POINT_WEIGHTS = "point_weights"
EXTRA_POINT_DENSITIES = "point_densities"
EXTRA_POINT_OCCUPANCIES = "point_occupancies"
EXTRA_POINT_DEPTHS = "point_depths"
EXTRA_SAMPLE_INTERVALS = "deltas"
EXTRA_DIFFUSE_COLOUR = "diffuse_colour"  # fused-diffuse render output (this framework only)
# device-scalar diagnostic of the bricked renderer (this framework only): True when a
# tile footprint exceeded the kernel patch and interpolation taps were dropped
EXTRA_BRICKED_TAP_OVERFLOW = "bricked_tap_overflow"

# keys used by checkpoints / saved-model info dicts
EXTRA_INFO = "extra_info"
CAMERA_BOUNDS = "camera_bounds"
CAMERA_INTRINSICS = "camera_intrinsics"
HEMISPHERICAL_RADIUS = "hemispherical_radius"

# keys of the serialized scene representation (reference thre3d_reprs/constants.py)
THRE3D_REPR = "thre3d_repr"
RENDER_PROCEDURE = "render_procedure"
RENDER_CONFIG_TYPE = "render_config_type"
STATE_DICT = "state_dict"
CONFIG_DICT = "config_dict"
RENDER_CONFIG = "render_config"
u_DENSITIES = "_densities"
u_FEATURES = "_features"

# keys of the per-image camera-params JSON files (reference data/constants.py)
INTRINSIC = "intrinsic"
EXTRINSIC = "extrinsic"
BOUNDS = "bounds"
HEIGHT = "height"
WIDTH = "width"
FOCAL = "focal"
ROTATION = "rotation"
TRANSLATION = "translation"

# visualization defaults (reference visualizations/constants.py)
NUM_FRAMES_PER_ANIMATION = 42
CAMERA_PITCH = -60.0
ANIMATION_FPS = 24
