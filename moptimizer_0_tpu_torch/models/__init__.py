"""Built-in residual models (the reference's test workloads, as blocks)."""

from moptimizer_0_tpu_torch.models.curve_fitting import exponential_curve_block, CERES_CURVE_DATA
from moptimizer_0_tpu_torch.models.rational import rational_block
from moptimizer_0_tpu_torch.models.powell import powell_block
from moptimizer_0_tpu_torch.models.point2point import point2point_block
from moptimizer_0_tpu_torch.models.camera import camera_reprojection_block
from moptimizer_0_tpu_torch.models.accelerometer import accelerometer_block
from moptimizer_0_tpu_torch.models.state import product_state_block
