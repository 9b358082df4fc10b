from moptimizer_0_tpu_torch.utils.stopwatch import Stopwatch, time_fn
from moptimizer_0_tpu_torch.utils.logging import Logger, format_trace
from moptimizer_0_tpu_torch.utils.pointcloud import load_txt_cloud
