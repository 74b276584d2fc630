from dicp_tpu.utils.profiling import benchmark, trace
from dicp_tpu.utils.checkpoint import save_odometry_state, load_odometry_state
from dicp_tpu.utils.timing import chained_rate

__all__ = ["benchmark", "trace", "save_odometry_state", "load_odometry_state",
           "chained_rate"]
